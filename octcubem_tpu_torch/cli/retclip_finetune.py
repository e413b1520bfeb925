"""CLIP-classification fine-tune: the COEM towers and a classification
head (counterpart of octcubem_tpu/cli/retclip_finetune.py).

    python -m octcubem_tpu_torch.cli.retclip_finetune --tiny \\
        --device cpu --epochs 1 --batch_size 4
    python -m octcubem_tpu_torch.cli.retclip_finetune --manifest_csv m.csv \\
        --parent_dir root --label_keys growth --init_ckpt retclip_run

Parity target: retinal-COEM/src/training/main_retclip_finetune_more_cls.py
and ..._3mod.py (SURVEY §2.8): k-fold CV with CustomTextCLIP(3Mod)
Classification, the single-modality ablation (``--single_modality``), the
CV checkpoint registry.  Every flag of the JAX CLI, with its meaning, and
the files it writes (``out.log``, ``results.jsonl``, ``ckpt_fold{k}/``,
``cv_registry.json``, and ``best_metrics.json`` for manifest runs).

The manifest flow (the reference's GA-growth pipeline):
- ``--manifest_csv`` / ``--parent_dir`` feed OCTFAFIRClsDataset (modes
  9/10/12); the folds come from the manifest's split column;
- labels are standardized with the TRAIN fold's statistics, reused for
  val, test and the independent tests;
- the towers start from a TRAINED retclip run (``--init_ckpt``, its
  params.txt geometry checked first); only the classification head stays
  fresh;
- per-label best-val tracking (r2_k), with the independent-test metrics
  captured at each new val best; a summary JSON of the collection.
Without a manifest the synthetic flow drives the same steps (as in the
JAX CLI, it takes no ``--init_ckpt``).

The models run in fp32, as the JAX CLI's.  Runs on the card
(``--device``, default cuda) unless given ``--device cpu``.  The host
reads step t-1's loss after it has issued step t.

Several cards: one process per card (``torchrun --nproc_per_node N -m
octcubem_tpu_torch.cli.retclip_finetune ...``).  As in the JAX CLI, whose
mesh puts every device on the data axis, ``--batch_size`` is the global
batch rounded to the data axis; every rank draws the same batches and
keeps its rows [r * B / N, (r + 1) * B / N), and the step takes the
criterion over the gathered logits and averages the gradient over the
ranks (train/clip_engine.py), so N ranks train as one.  Every rank
evaluates the whole split; rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def _build_parser():
    parser = argparse.ArgumentParser("OCTCube retclip classification "
                                     "(PyTorch)")
    parser.add_argument("--three_mod", action="store_true")
    parser.add_argument("--single_modality", default=None,
                        choices=[None, "image", "enface", "enface1", "enface2"])
    parser.add_argument("--num_classes", type=int, default=2,
                        help="classes (synthetic multi_cls); manifest runs "
                             "take the output count from label_keys")
    parser.add_argument("--k_folds", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0.1)
    parser.add_argument("--synthetic_n", type=int, default=32)
    parser.add_argument("--output_dir", default="./output_retclip_cls")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--manifest_csv", default=None,
                        help="OCTFAFIRClsDataset manifest (build_ga_manifest)")
    parser.add_argument("--parent_dir", default="",
                        help="root the manifest's relative paths resolve from")
    parser.add_argument("--multimodal_type", default="oct3d_paired_faf_cls",
                        help="9/10/12 or their names (data/multimodal.py "
                             "MODE_MAPPING)")
    parser.add_argument("--label_keys", default=None,
                        help="comma-separated manifest label columns")
    parser.add_argument("--split_key", default="split1")
    parser.add_argument("--task", default=None,
                        choices=[None, "regression", "multi_cls"],
                        help="default: regression for manifest runs "
                             "(GA growth), multi_cls for synthetic")
    parser.add_argument("--independent_manifest_csv", action="append",
                        default=None,
                        help="repeatable: held-out independent test "
                             "manifest(s), never used for fold selection")
    parser.add_argument("--init_ckpt", default=None,
                        help="trained retclip run dir (or its ckpt/ dir) "
                             "for tower initialization")
    parser.add_argument("--model_config", default=None,
                        help="COEM JSON config name/path (models/configs): "
                             "the tower geometry from the config; the "
                             "--tiny / default geometries are the fallback")
    parser.add_argument("--lock_image", action="store_true",
                        help="freeze the visual trunk except the last "
                             "--lock_image_unlocked_groups groups (real "
                             "freezing: no frozen backward, no frozen "
                             "optimizer moments)")
    parser.add_argument("--lock_image_unlocked_groups", type=int, default=9)
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    return parser


def _model_cfgs(args):
    if args.tiny:
        vcfg = dict(num_frames=6, t_patch_size=3, img_size=32, patch_size=16,
                    in_chans=1, embed_dim=32, depth=2, num_heads=2)
        ecfg = dict(img_size=32, patch_size=16, in_chans=3, embed_dim=32,
                    depth=2, num_heads=2)
        edim = 16
    else:
        vcfg = dict(num_frames=60, t_patch_size=3, img_size=256,
                    patch_size=16, in_chans=1, embed_dim=1024, depth=24,
                    num_heads=16)
        ecfg = dict(img_size=384, patch_size=16, in_chans=3, embed_dim=1024,
                    depth=24, num_heads=16)
        edim = 512
    return vcfg, ecfg, edim


def _build_model(args, num_outputs, device, seed):
    """A fresh seeded model and its tower geometries: from --model_config
    through the COEM JSON factory (as cli/retclip.py builds), else the
    flag-driven geometries.  -> (model, vcfg, ecfg)."""
    from ..models import coem, registry

    if args.model_config:
        model = registry.create_coem_model(args.model_config,
                                           num_classes=num_outputs,
                                           device=device, seed=seed)
        is3 = isinstance(model, coem.COEP3TowerClassification)
        if args.three_mod and not is3:
            raise SystemExit(
                f"--model_config {args.model_config} is a 2-tower config "
                "but the run needs 3 modalities (--three_mod / a "
                "faf+ir manifest mode)")
        args.three_mod = is3
        return (model, dict(model.vision_cfg or {}),
                dict(model.enface_cfg or {}))
    vcfg, ecfg, edim = _model_cfgs(args)
    if args.three_mod:
        cls, ecfg_m = (coem.COEP3TowerClassification,
                       dict(ecfg, num_mod_head=2))
    else:
        cls, ecfg_m = coem.COEP2TowerClassification, ecfg
    model = coem.create_model(cls, device=device, seed=seed, embed_dim=edim,
                              num_classes=num_outputs, vision_cfg=vcfg,
                              enface_cfg=ecfg_m)
    return model, vcfg, ecfg


def _optimizer(args, model, vcfg, log):
    """The AdamW of a fold, over the trainable params: with --lock_image
    the visual trunk trains only its last groups (optim.lit_lock_scales
    with the classification models' 'clip.visual.' prefix) and the rest is
    frozen for real (optim.make_partition)."""
    from ..train import optim

    params = dict(model.named_parameters())
    if args.lock_image:
        prefix = "clip.visual." if hasattr(model, "clip") else "visual."
        scales = optim.lit_lock_scales(model, vcfg.get("depth", 24),
                                       args.lock_image_unlocked_groups,
                                       tower_prefix=prefix)
        n_frozen = sum(int(s == 0) for s in scales.values())
        if not n_frozen and (args.lock_image_unlocked_groups
                             < vcfg.get("depth", 24) + 2):
            raise ValueError("lock matched no parameters")
        params = optim.make_partition(model,
                                      {k: s > 0 for k, s in scales.items()})
        log.info(f"LiT lock: {n_frozen} frozen param tensors, "
                 f"{args.lock_image_unlocked_groups} unlocked groups")
    return optim.build_adamw(params, args.lr, weight_decay=args.weight_decay)


def _mesh(device):
    """-> (mesh or None, this rank's data index, the data size, the main
    rank's flag): every rank on the data axis, as the JAX CLI's
    ``make_mesh()``."""
    from ..core import multihost
    from ..core.mesh import DATA_AXIS, axis_coord, cli_mesh

    mesh = cli_mesh(device=device)
    return (mesh, *axis_coord(mesh, DATA_AXIS),
            multihost.world()[0] == 0)


def _train_epoch(step, state, batches, d_idx: int = 0, n_data: int = 1):
    """One epoch of steps on this rank's rows of each global batch ->
    (state, the mean loss); step t-1's loss is read after step t is
    issued."""
    losses, pending = [], None
    for b in batches:
        rows = next(iter(b.values())).shape[0] // n_data
        b = {k: v[d_idx * rows:(d_idx + 1) * rows] for k, v in b.items()}
        state, m = step(state, b)
        if pending is not None:
            losses.append(float(pending["loss"]))
        pending = m
    if pending is not None:
        losses.append(float(pending["loss"]))
    return state, float(np.mean(losses))


def main(argv=None):
    args = _build_parser().parse_args(argv)
    from ..core import multihost
    from ..core.device import resolve_device

    device = resolve_device(args.device)
    multihost.announce(device)
    if args.manifest_csv:
        return _main_manifest(args, device)
    return _main_synthetic(args, device)


# ------------------------------------------------------------- synthetic

def _main_synthetic(args, device):
    from ..core import checkpoint as ckpt_lib, ckpt_registry
    from ..core.device import to_device
    from ..train import clip_engine, losses, metrics as metrics_lib
    from ..train.train_state import TrainState
    from ..utils.logging import JsonlLogger, get_logger

    os.makedirs(args.output_dir, exist_ok=True)
    log = get_logger("retclip_cls", os.path.join(args.output_dir, "out.log"))
    model, vcfg, ecfg = _build_model(args, args.num_classes, device, 0)
    # 2D-vision configs carry no num_frames: 60, as cli/retclip.py reads
    frames, osz, esz = (vcfg.get("num_frames", 60), vcfg["img_size"],
                        ecfg["img_size"])

    def sample(i):
        rng = np.random.default_rng((11, i))
        label = i % args.num_classes
        vol = rng.random((frames, osz, osz, 1), np.float32) + 0.1 * label
        enf = rng.random((esz, esz, 3), np.float32) + 0.1 * label
        return vol, enf, np.int64(label)

    items = [sample(i) for i in range(args.synthetic_n)]
    mesh, d_idx, n_data, main_rank = _mesh(device)
    batch = max(n_data, (args.batch_size // n_data) * n_data)

    sm = args.single_modality
    if args.three_mod and sm == "enface":
        sm = "enface1"

    def batches(idx, shuffle_seed=None):
        idx = list(idx)
        if shuffle_seed is not None:
            np.random.default_rng(shuffle_seed).shuffle(idx)
        for s in range(0, len(idx) - batch + 1, batch):
            sel = [items[i] for i in idx[s:s + batch]]
            vol = to_device(np.stack([x[0] for x in sel]), device)
            enf = to_device(np.stack([x[1] for x in sel]), device)
            y = to_device(np.stack([x[2] for x in sel]), device)
            if args.three_mod:
                yield {"image": vol, "enface1": enf,
                       "enface2": torch.flip(enf, dims=(1,)), "label": y}
            else:
                yield {"image": vol, "enface": enf, "label": y}

    registry_entries = {}
    jsonl = JsonlLogger(args.output_dir, "results.jsonl")
    fold_splits = np.array_split(np.arange(len(items)), args.k_folds)

    for fold in range(args.k_folds):
        val_idx = fold_splits[fold]
        train_idx = np.concatenate(
            [fold_splits[j] for j in range(args.k_folds) if j != fold])
        if fold:  # a fresh model each fold, seeded by the fold
            model, vcfg, ecfg = _build_model(args, args.num_classes, device,
                                             fold)
        tx = _optimizer(args, model, vcfg, log)
        state = TrainState.create(model, tx, fold + 100)
        step = clip_engine.make_clip_cls_train_step(
            model, tx, losses.softmax_ce, three_mod=args.three_mod,
            single_modality=sm, mesh=mesh)
        predict = clip_engine.make_clip_cls_predict_step(
            model, three_mod=args.three_mod, single_modality=sm)
        best_auc, best_epoch = -1.0, -1
        for epoch in range(args.epochs):
            state, train_loss = _train_epoch(
                step, state, batches(train_idx, shuffle_seed=(fold, epoch)),
                d_idx, n_data)
            preds, trues = [], []
            for b in batches(val_idx):
                y = b.pop("label")
                preds.append(predict(b).float().cpu().numpy())
                trues.append(y.cpu().numpy())
            m = metrics_lib.compute_metrics(
                "multi_cls", np.concatenate(trues), np.concatenate(preds))
            auc = m["macro_roc_ovr"]
            if auc > best_auc:
                best_auc, best_epoch = auc, epoch
                cdir = os.path.join(args.output_dir, f"ckpt_fold{fold}")
                ckpt_lib.save_checkpoint(cdir, epoch, state, {"epoch": epoch},
                                         keep_last=1, async_save=True)
                registry_entries[fold] = {
                    "best_val": os.path.join(cdir, str(epoch)),
                    "best_test": os.path.join(cdir, str(epoch))}
            jsonl.write({"fold": fold, "epoch": epoch,
                         "train_loss": train_loss, "val_auc_ovr": auc,
                         "val_acc": m["overall_acc"]})
        log.info(f"fold {fold}: best AUC {best_auc:.3f} @ {best_epoch}")
        ckpt_lib.wait_for_saves(os.path.join(args.output_dir,
                                             f"ckpt_fold{fold}"))
    if main_rank:
        ckpt_registry.save_ckpt_registry(
            os.path.join(args.output_dir, "cv_registry.json"),
            registry_entries)
    return registry_entries


# ----------------------------------------------------- manifest (GA growth)

def _main_manifest(args, device):
    from ..core import checkpoint as ckpt_lib, ckpt_registry
    from ..core.device import to_device
    from ..data.multimodal import MODE_MAPPING, OCTFAFIRClsDataset
    from ..train import clip_engine, losses, metrics as metrics_lib
    from ..train.train_state import TrainState
    from ..utils.logging import JsonlLogger, get_logger

    os.makedirs(args.output_dir, exist_ok=True)
    log = get_logger("retclip_cls", os.path.join(args.output_dir, "out.log"))
    task = args.task or "regression"
    mode = MODE_MAPPING.get(
        int(args.multimodal_type) if str(args.multimodal_type).isdigit()
        else args.multimodal_type, args.multimodal_type)
    args.three_mod = args.three_mod or mode == "oct3d_paired_faf_ir_cls"
    label_keys = [k for k in (args.label_keys or "").split(",") if k]
    if not label_keys:
        raise SystemExit("--label_keys required for manifest runs")

    num_outputs = len(label_keys) if task == "regression" else args.num_classes
    model, vcfg, ecfg = _build_model(args, num_outputs, device, 0)
    if args.init_ckpt:
        # the geometry guard BEFORE any fold trains: an enc8-trained
        # retclip checkpoint loads cleanly into 16-head towers
        clip_engine.check_retclip_run_geometry(args.init_ckpt, vcfg, ecfg)
    three_mod = args.three_mod  # a 3-tower --model_config upgrades the run
    frames, osz, esz = (vcfg.get("num_frames", 60), vcfg["img_size"],
                        ecfg["img_size"])

    def build_ds(csv):
        return OCTFAFIRClsDataset(
            csv, args.parent_dir, mode=mode, label_keys=label_keys,
            num_frames=frames, oct_size=osz, enface_size=esz,
            split_key=args.split_key, standardize=False)

    ds = build_ds(args.manifest_csv)
    ind_sets = [build_ds(p) for p in (args.independent_manifest_csv or [])]
    # fail at startup, not after a fold-epoch of training
    for p, ind in zip(args.independent_manifest_csv or [], ind_sets):
        if len(ind) == 0:
            raise SystemExit(f"--independent_manifest_csv {p}: 0 usable rows")
    folds = ds.available_split[:args.k_folds]
    log.info(f"manifest: {len(ds)} rows, folds {folds}, "
             f"labels {label_keys}, mode {mode}, "
             f"{len(ind_sets)} independent test set(s)")

    sm = args.single_modality
    if three_mod and sm == "enface":
        sm = "enface1"
    criterion = (losses.mse_loss if task == "regression"
                 else losses.softmax_ce)
    metric_mode = ("multi_output_regression" if task == "regression"
                   else "multi_cls")
    mesh, d_idx, n_data, main_rank = _mesh(device)
    batch = max(n_data, (args.batch_size // n_data) * n_data)

    def batches(dataset, rows, mu, sd, shuffle_seed=None, drop_last=True):
        rows = list(rows)
        if shuffle_seed is not None:
            np.random.default_rng(shuffle_seed).shuffle(rows)
        stop = (len(rows) - batch + 1) if drop_last else len(rows)
        for s in range(0, max(stop, 0), batch):
            sel = rows[s:s + batch]
            if not drop_last and len(sel) < batch:
                sel = (sel * (batch // len(sel) + 1))[:batch]  # repeat-pad
            samples = [dataset[i] for i in sel]
            vols = np.stack([x["image"] for x in samples])
            e1 = np.stack([x["enface1"] for x in samples])
            e2 = np.stack([x["enface2"] for x in samples])
            y = np.stack([x["label"] for x in samples]).astype(np.float32)
            if task == "regression":
                y = ((y - mu) / sd).astype(np.float32)
            else:
                y = y[:, 0].astype(np.int64)
            out = {"image": to_device(vols, device),
                   "label": to_device(y, device)}
            if three_mod:
                out["enface1"] = to_device(e1, device)
                out["enface2"] = to_device(e2, device)
            else:
                # 2-tower: the en face side is FAF for mode 9, IR for 10
                out["enface"] = to_device(
                    e2 if mode == "oct3d_paired_faf_cls" else e1, device)
            yield out

    def eval_rows(predict, dataset, rows, mu, sd):
        preds, trues = [], []
        n_seen = 0
        for b in batches(dataset, rows, mu, sd, drop_last=False):
            y = b.pop("label")
            p = predict(b).float().cpu().numpy()
            take = min(batch, len(rows) - n_seen)
            preds.append(p[:take])
            trues.append(y.cpu().numpy()[:take])
            n_seen += take
        return metrics_lib.compute_metrics(metric_mode, np.concatenate(trues),
                                           np.concatenate(preds))

    # per-label ongoing-best collection (main_…_3mod.py:52-158): per label
    # k and fold, the best val metrics, their epoch, and the independent
    # test metrics captured at that epoch
    n_track = num_outputs if task == "regression" else 1
    collection = {
        "best_val": [[None] * len(folds) for _ in range(n_track)],
        "best_val_epoch": [[-1] * len(folds) for _ in range(n_track)],
        "independent_test_at_best_val": [
            [[None] * len(folds) for _ in range(n_track)]
            for _ in ind_sets],
    }
    registry_entries = {}
    jsonl = JsonlLogger(args.output_dir, "results.jsonl")

    for fi, fold in enumerate(folds):
        train_rows, val_rows = ds.cv_indices(fold)
        if not (train_rows and val_rows):
            raise ValueError(f"fold {fold}: {len(train_rows)} train and "
                             f"{len(val_rows)} val rows")
        if len(train_rows) < batch:
            raise ValueError(
                f"fold {fold}: train side has {len(train_rows)} rows but "
                f"the batch is {batch}: lower --batch_size or use fewer "
                "folds")
        mu, sd = (ds.raw_label_stats(train_rows) if task == "regression"
                  else (0.0, 1.0))
        if fi or int(fold):  # a fresh model each fold, seeded by it
            model, vcfg, ecfg = _build_model(args, num_outputs, device,
                                             int(fold))
        if args.init_ckpt:
            _, copied = clip_engine.init_towers_from_retclip(model,
                                                             args.init_ckpt)
            log.info(f"fold {fold}: towers initialized from "
                     f"{args.init_ckpt} ({copied} tensors; "
                     "classification head fresh)")
        tx = _optimizer(args, model, vcfg, log)
        state = TrainState.create(model, tx, int(fold) + 100)
        step = clip_engine.make_clip_cls_train_step(
            model, tx, criterion, three_mod=three_mod, single_modality=sm,
            mesh=mesh)
        predict = clip_engine.make_clip_cls_predict_step(
            model, three_mod=three_mod, single_modality=sm)

        primary = "r2_macro" if task == "regression" else "macro_roc_ovr"
        best_primary, best_epoch = -np.inf, -1
        for epoch in range(args.epochs):
            state, train_loss = _train_epoch(
                step, state, batches(ds, train_rows, mu, sd,
                                     shuffle_seed=(fold, epoch)),
                d_idx, n_data)
            val_m = eval_rows(predict, ds, val_rows, mu, sd)
            ind_ms = [eval_rows(predict, d, list(range(len(d))), mu, sd)
                      for d in ind_sets]
            # per-label best-val update with independent-test capture
            for k in range(n_track):
                key = f"r2_{k}" if task == "regression" else primary
                prev = collection["best_val"][k][fi]
                if prev is None or val_m[key] >= prev[key]:
                    collection["best_val"][k][fi] = val_m
                    collection["best_val_epoch"][k][fi] = epoch
                    for ti, im in enumerate(ind_ms):
                        collection["independent_test_at_best_val"][
                            ti][k][fi] = im
            if val_m[primary] > best_primary:
                best_primary, best_epoch = val_m[primary], epoch
                cdir = os.path.join(args.output_dir, f"ckpt_fold{fold}")
                ckpt_lib.save_checkpoint(cdir, epoch, state, {"epoch": epoch},
                                         keep_last=1, async_save=True)
                registry_entries[fold] = {
                    "best_val": os.path.join(cdir, str(epoch)),
                    "best_test": os.path.join(cdir, str(epoch))}
            row = {"fold": int(fold), "epoch": epoch,
                   "train_loss": train_loss,
                   **{f"val_{k}": v for k, v in val_m.items()}}
            for ti, im in enumerate(ind_ms):
                row.update({f"ind{ti}_{k}": v for k, v in im.items()})
            jsonl.write(row)
        log.info(f"fold {fold}: best {primary} {best_primary:.3f} "
                 f"@ epoch {best_epoch}")
        ckpt_lib.wait_for_saves(os.path.join(args.output_dir,
                                             f"ckpt_fold{fold}"))

    if main_rank:
        ckpt_registry.save_ckpt_registry(
            os.path.join(args.output_dir, "cv_registry.json"),
            registry_entries)
    summary = {
        "label_keys": label_keys, "folds": [int(f) for f in folds],
        "best_val": collection["best_val"],
        "best_val_epoch": collection["best_val_epoch"],
        "independent_test_at_best_val":
            collection["independent_test_at_best_val"],
    }
    if main_rank:
        with open(os.path.join(args.output_dir, "best_metrics.json"),
                  "w") as f:
            json.dump(summary, f, indent=2, default=float)
    log.info("manifest fine-tune complete")
    return summary


if __name__ == "__main__":
    main()
