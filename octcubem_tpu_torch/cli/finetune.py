"""Downstream fine-tune entry point, single-fold or k-fold (counterpart of
octcubem_tpu/cli/finetune.py).

    python -m octcubem_tpu_torch.cli.finetune --preset octcube_multitask \\
        --synthetic --synthetic_n 10 --epochs 1 --output_dir ./out
    python -m octcubem_tpu_torch.cli.finetune --slivit_dataset ct3d \\
        --data_dir nodulemnist3d.npz --epochs 20
    python -m octcubem_tpu_torch.cli.finetune --tiny --synthetic \\
        --device cpu --epochs 1 --batch_size 8

Parity target: OCTCube/main_finetune_downstream_inhouse_singlefold.py
(SURVEY §3.2): model dispatch, the pretrained import with the head
stripped and the pos embeds interpolated, layer-decay AdamW at the LR
``scale_base_lr(blr, batch)``, per-epoch train / val and, at each new val
best, an async checkpoint (keep_last=1), the test split, the metric CSVs
and confusion images; log.txt JSON lines, TensorBoard scalars, early
stopping.  Every flag of the JAX CLI, with its meaning, and the files it
writes (``args.json``, ``out.log``, ``log{fold}.txt``, ``tb{fold}/``,
``ckpt{fold}/{epoch}``, ``macro_metrics_{val,test}{fold}.csv``, the
per-class CSVs, ``confusion_test{fold}*.png``).

Runs on the card (``--device``, default cuda; every ViT attention call
runs the hand-written kernels, B1 forward and B2 backward) and refuses
to start without one unless given ``--device cpu``.  One rank: the JAX
CLI's data-parallel size is 1 here, and ``n_data`` / ``n_fsdp`` above 1
or a multi-process launch raise NotImplementedError naming ROADMAP A14.
As in the JAX CLI, the host reads step t-1's loss and finiteness after
it has issued step t; a non-finite step is reverted on the device
(train/finetune_engine.py) and counted in the epoch's ``nan_steps``.

Layer decay: the JAX CLI computes the scales over its params tree with
the ``params`` root, where no path starts with ``cls_token``,
``pos_embed`` or ``patch_embed``; so the embeddings take the head's
scale, and the port computes them the same way (``name_prefix``).  The
block count is the model's ``depth`` where the family has one, else 24,
as JAX's ``getattr(model, "depth", 24)`` (the SLIViT families).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from ..core.device import resolve_device, to_device

_A14 = ("is ROADMAP A14 (DDP / FSDP over torch.distributed); the port's "
        "fine-tuning runs on one rank")


class SyntheticCls3D:
    """Seeded synthetic volumes and labels, the JAX CLI's draws."""

    def __init__(self, n, frames, size, n_label_cols, task_mode, seed=0):
        self.n, self.frames, self.size = n, frames, size
        self.n_label_cols = n_label_cols
        self.task_mode = task_mode
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng((self.seed, i))
        vol = rng.random((self.frames, self.size, self.size, 1), np.float32)
        if (self.task_mode in ("multi_label",)
                or self.task_mode.startswith("multi_task")):
            lab = (rng.random(self.n_label_cols) > 0.5).astype(np.float32)
            if lab[1:].sum() > 0:
                lab[0] = 0.0
            else:
                lab[0] = 1.0
        elif self.task_mode == "regression":
            lab = rng.standard_normal(1).astype(np.float32)
        else:
            lab = np.int64(rng.integers(0, self.n_label_cols))
        return vol, lab


class _Items:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def build_model(cfg, dtype, device):
    """The preset's model from the registry, with seeded weights."""
    from ..models import registry

    if cfg.model_family == "slivit":
        # slivit_baseline (no drop-path knob in the reference build) or
        # *_slivit (a ViT-ST trunk, drop_path_rate=args.drop_path)
        kw = dict(num_classes=cfg.num_classes,
                  slivit_depth=cfg.slivit_depth, dtype=dtype)
        if cfg.model == "slivit_baseline":
            kw.update(num_frames=cfg.num_frames, img_size=cfg.input_size)
        else:
            kw.update(num_frames=cfg.num_frames,
                      t_patch_size=cfg.t_patch_size,
                      img_size=cfg.input_size, in_chans=cfg.in_chans,
                      drop_path_rate=cfg.drop_path)
        return registry.create_model("slivit", cfg.model, device=device,
                                     seed=cfg.seed, **kw)
    kw = dict(num_classes=cfg.num_classes, drop_path_rate=cfg.drop_path,
              dtype=dtype)
    if cfg.model_family in ("vit_st", "vit_st_dropout"):
        kw.update(num_frames=cfg.num_frames, t_patch_size=cfg.t_patch_size,
                  img_size=cfg.input_size, in_chans=cfg.in_chans,
                  global_pool=cfg.global_pool, sep_pos_embed=cfg.sep_pos_embed,
                  cls_embed=cfg.cls_embed, num_heads=cfg.num_heads)
        if getattr(cfg, "variable_joint", False):
            # the joint dual-res model: a second 512^2 patch embed, the pos
            # embed stored at the high-res grid
            kw.update(high_res_input_size=cfg.high_res_input_size)
    else:  # vit_3dhead, vit2d
        kw.update(img_size=cfg.input_size, in_chans=cfg.in_chans,
                  global_pool=cfg.global_pool)
    return registry.create_model(cfg.model_family, cfg.model, device=device,
                                 seed=cfg.seed, **kw)


def _tiny_model(cfg, dtype, device):
    """The JAX CLI's ``--tiny`` models, with seeded weights."""
    if cfg.slivit_dataset:
        from ..models import slivit

        return slivit.create_model(
            slivit.SLIViT, device=device, seed=cfg.seed,
            num_patches=cfg.num_frames, num_classes=cfg.num_classes,
            slice_size=cfg.input_size, vit_depth=cfg.slivit_depth,
            convnext_depths=(1, 1, 1, 1), convnext_dims=(8, 8, 8, 16),
            dtype=dtype)
    from ..models import vit_st

    return vit_st.create_model(
        vit_st.VisionTransformerST, device=device, seed=cfg.seed,
        num_frames=cfg.num_frames, t_patch_size=3, img_size=cfg.input_size,
        in_chans=1, num_classes=cfg.num_classes, embed_dim=32, depth=2,
        num_heads=2, dtype=dtype, attn_impl="auto",
        high_res_input_size=(cfg.high_res_input_size
                             if cfg.variable_joint else None))


def run_fold(cfg, make_model, datasets, log, device, fold_tag=""):
    """One fold: a fresh seeded model, its training epochs and evals ->
    (BestTracker, the best epoch's test metrics)."""
    from ..compat.torch_import import (check_geometry_stamp,
                                       load_reference_weights,
                                       load_torch_checkpoint)
    from ..core import checkpoint as ckpt_lib
    from ..data import loader as loader_lib
    from ..train import losses, optim, schedules
    from ..train.finetune_engine import (
        BestTracker, evaluate, make_finetune_train_step, make_predict_step,
        write_confusion_matrices, write_metric_csvs)
    from ..train.train_state import TrainState
    from ..utils.logging import JsonlLogger, MetricLogger, TBWriter

    ds_train, ds_val, ds_test = datasets
    batch = min(cfg.batch_size, len(ds_train))  # one rank: data size 1
    ld_tr = loader_lib.Loader(ds_train, batch, num_workers=4, seed=cfg.seed)
    assert len(ld_tr) > 0, "empty train loader (batch larger than dataset?)"
    ld_va = loader_lib.Loader(ds_val, batch, shuffle=False, drop_last=False,
                              num_workers=2)
    ld_te = loader_lib.Loader(ds_test, batch, shuffle=False, drop_last=False,
                              num_workers=2)
    # variable_joint: the dataset yields (low_res, high_res) pairs; training
    # alternates the two streams through the joint model's resolution
    # dispatch, so both patch embeds train; evaluation takes the high-res
    # stream
    variable_joint = isinstance(ds_train[0][0], tuple)

    model = make_model()
    if cfg.finetune_ckpt:
        check_geometry_stamp(cfg.finetune_ckpt, cfg.num_heads)
        # the head is stripped (the reference filters mismatched heads)
        report = load_reference_weights(
            model, load_torch_checkpoint(cfg.finetune_ckpt), strict=False,
            drop_keys=("head",))
        log.info(f"loaded {cfg.finetune_ckpt}; new params: "
                 f"{report['missing']}")

    lr = schedules.scale_base_lr(cfg.blr, batch)
    steps = max(1, len(ld_tr))
    sched = schedules.warmup_half_cosine(lr, cfg.min_lr, cfg.warmup_epochs,
                                         cfg.epochs, steps)
    tx = optim.build_adamw(model, sched, cfg.weight_decay,
                           layer_decay=cfg.layer_decay,
                           num_blocks=getattr(model, "depth", 24),
                           clip_grad=cfg.clip_grad,
                           name_prefix="params.")
    state = TrainState.create(model, tx, cfg.seed + 1)

    crit = losses.make_criterion(cfg.task_mode, smoothing=cfg.smoothing,
                                 use_focal=cfg.use_focal)
    step_fn = make_finetune_train_step(model, tx, crit)
    predict = make_predict_step(model)
    tracker = BestTracker(patience=cfg.early_stop_patience)
    jsonl = JsonlLogger(cfg.output_dir, f"log{fold_tag}.txt")
    # epoch_1000x-convention TensorBoard scalars (engine_finetune.py:471-477)
    tb = TBWriter(os.path.join(cfg.output_dir, f"tb{fold_tag}"))
    ckpt_dir = os.path.join(cfg.output_dir, f"ckpt{fold_tag}")

    def eval_batches(ld):
        for x, y in ld:
            if variable_joint:
                x = x[1]  # the high-res stream
            yield to_device(x, device), y

    best_test = None
    for epoch in range(cfg.epochs):
        ld_tr.set_epoch(epoch)
        meter = MetricLogger()
        n_nan = 0

        def consume(m):
            nonlocal n_nan
            ok = bool(m["finite"])
            n_nan += 0 if ok else 1
            meter.update(loss=float(m["loss"]) if ok else 0.0)

        pending = None  # step t-1's metrics, read after step t is issued
        for it, (x, y) in enumerate(meter.log_every(
                ld_tr, 10, f"Epoch [{epoch}]{fold_tag}", logger=log)):
            if variable_joint:
                x = x[(epoch + it) % 2]  # alternate low / high-res streams
            state, m = step_fn(state, to_device(x, device),
                               to_device(np.asarray(y), device))
            if pending is not None:
                consume(pending)
            pending = m
        if pending is not None:
            consume(pending)
        val_metrics, _, _ = evaluate(predict, eval_batches(ld_va),
                                     cfg.task_mode)
        improved = tracker.update(epoch, val_metrics)
        record = {"epoch": epoch,
                  "train_loss": meter.meters["loss"].global_avg,
                  "val_auc": val_metrics.get("roc", {}).get("macro"),
                  "nan_steps": n_nan, "best": improved}
        if improved:
            ckpt_lib.save_checkpoint(ckpt_dir, epoch, state, {"epoch": epoch},
                                     keep_last=1, async_save=True)
            test_metrics, yt, yp = evaluate(predict, eval_batches(ld_te),
                                            cfg.task_mode)
            tracker.best_test_metrics = test_metrics
            best_test = test_metrics
            write_metric_csvs(val_metrics, cfg.output_dir, f"val{fold_tag}")
            write_metric_csvs(test_metrics, cfg.output_dir, f"test{fold_tag}")
            write_confusion_matrices(yt, yp, cfg.task_mode, cfg.output_dir,
                                     f"test{fold_tag}")
            record["test_auc"] = test_metrics.get("roc", {}).get("macro")
        jsonl.write(record)
        tb.scalar("train_loss", record["train_loss"], epoch + 1)
        if record.get("val_auc") is not None:
            tb.scalar("val_auc", record["val_auc"], epoch + 1)
        tb.flush()
        log.info(f"epoch {epoch}: {record}")
        if tracker.should_stop:
            log.info(f"early stop at epoch {epoch}")
            break
    ckpt_lib.wait_for_saves(ckpt_dir)
    return tracker, best_test


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("OCTCube downstream fine-tune (PyTorch)")
    parser.add_argument("--preset", default="octcube_multitask")
    parser.add_argument("--data_dir", default=None)
    parser.add_argument("--labels_csv", default=None,
                        help="CSV with patient_id + disease columns "
                             "(data/patients.attach_labels_from_csv)")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synthetic_n", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--k_folds", type=int, default=None)
    parser.add_argument("--variable_joint", action="store_true", default=None)
    parser.add_argument("--slivit_dataset", choices=["ct3d", "us3d"],
                        default=None,
                        help="SLIViT cross-modality data: ct3d = "
                             "nodulemnist3d.npz at --data_dir; us3d = "
                             "EchoNet root at --data_dir")
    parser.add_argument("--num_heads", type=int, default=None,
                        help="encoder heads; must match the pretrain "
                             "geometry of finetune_ckpt (16 = reference "
                             "checkpoints, 8 = vitl_mae_tpu_native_enc8)")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    return parser


def main(argv=None):
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)

    from ..core import multihost
    from ..core.config import FinetuneConfig, load_config, to_json
    from ..data import patients, transforms
    from ..utils.logging import get_logger

    info = multihost.announce(device)
    if info["process_count"] > 1:
        raise NotImplementedError(f"a world size of {info['process_count']} "
                                  + _A14)
    if args.slivit_dataset and args.preset == "octcube_multitask":
        args.preset = f"slivit_{args.slivit_dataset}"  # canonical preset
    overrides = {k: v for k, v in (
        ("epochs", args.epochs), ("batch_size", args.batch_size),
        ("output_dir", args.output_dir), ("k_folds", args.k_folds),
        ("variable_joint", args.variable_joint),
        ("num_heads", args.num_heads),
        ("slivit_dataset", args.slivit_dataset))
        if v is not None}
    cfg = load_config(FinetuneConfig, args.preset, **overrides)
    for name in ("n_data", "n_fsdp"):
        if (getattr(cfg, name) or 1) > 1:
            raise NotImplementedError(f"{name}={getattr(cfg, name)} " + _A14)
    if args.tiny:
        cfg = dataclasses.replace(
            cfg, num_frames=6, input_size=32, num_classes=6,
            high_res_input_size=64, disease_list=("AMD", "DME", "POG"))
        if cfg.slivit_dataset:
            # the trunk's stride is 32, so slices stay >= 32 px; the
            # ConvNeXt and head depths shrink instead of the geometry
            cfg = dataclasses.replace(
                cfg, num_frames=4, num_classes=2 if
                cfg.slivit_dataset == "ct3d" else 1, slivit_depth=1,
                disease_list=("nodule",) if cfg.slivit_dataset == "ct3d"
                else ("EF",),
                task_mode="multi_cls" if cfg.slivit_dataset == "ct3d"
                else "regression")
    os.makedirs(cfg.output_dir, exist_ok=True)
    log = get_logger("finetune", os.path.join(cfg.output_dir, "out.log"))
    with open(os.path.join(cfg.output_dir, "args.json"), "w") as f:
        f.write(to_json(cfg))

    dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
    if args.tiny:
        def make_model():
            return _tiny_model(cfg, dtype, device)
    else:
        def make_model():
            return build_model(cfg, dtype, device)

    # ---- datasets
    if cfg.slivit_dataset is not None and args.data_dir is not None:
        # SLIViT cross-modality experiments: predefined splits, one fold
        from ..data import crossmodal

        if cfg.slivit_dataset == "ct3d":
            def mk(split):
                return crossmodal.MedMNIST3DDataset(
                    args.data_dir, split, num_frames=cfg.num_frames,
                    input_size=cfg.input_size)
            folds = [(mk("train"), mk("val"), mk("test"))]
        else:  # us3d: EchoNet EF regression
            def mk(split):
                return crossmodal.EchoNetDataset(
                    args.data_dir, split, num_frames=cfg.num_frames,
                    input_size=cfg.input_size)
            folds = [(mk("TRAIN"), mk("VAL"), mk("TEST"))]
    elif args.synthetic or args.data_dir is None:
        full = SyntheticCls3D(args.synthetic_n, cfg.num_frames,
                              cfg.input_size, 1 + len(cfg.disease_list),
                              cfg.task_mode)
        n = len(full)

        def part(lo, hi):
            return _Items([full[i] for i in range(lo, hi)])

        folds = [(part(0, n * 6 // 10), part(n * 6 // 10, n * 8 // 10),
                  part(n * 8 // 10, n))]
    else:
        visits = patients.scan_directory(args.data_dir)
        if args.labels_csv:
            visits = patients.attach_labels_from_csv(visits, args.labels_csv)
            log.info(f"{len(visits)} visits matched {args.labels_csv}")
        _, label_fn = patients.build_labels(visits, cfg.task_mode,
                                            disease_list=cfg.disease_list)
        tr_t, va_t = transforms.create_3d_transforms(cfg.input_size,
                                                     cfg.num_frames)
        hi_tr = hi_va = None
        if cfg.variable_joint:
            # dual-res transforms (main_…singlefold.py:269-276)
            hi_frames = cfg.high_res_num_frames or cfg.num_frames
            hi_tr, hi_va = transforms.create_3d_transforms(
                cfg.high_res_input_size, hi_frames)
        folds = []
        for fold in range(max(1, cfg.k_folds)):
            trv, vav, tev = patients.kfold_patient_split(
                visits, max(2, cfg.k_folds), fold, seed=cfg.seed)

            def mk3(vs, t, hi):
                return patients.PatientDataset3D(
                    vs, label_fn, max_frames=cfg.num_frames, transform=t,
                    return_both_res_image=cfg.variable_joint,
                    high_res_transform=hi,
                    high_res_max_frames=(cfg.high_res_num_frames
                                         or cfg.num_frames))
            folds.append((mk3(trv, tr_t, hi_tr), mk3(vav, va_t, hi_va),
                          mk3(tev, va_t, hi_va)))

    results = []
    for fold, datasets in enumerate(folds):
        tag = f"_fold{fold}" if len(folds) > 1 else ""
        tracker, _ = run_fold(cfg, make_model, datasets, log, device, tag)
        results.append((tracker.best_auc, tracker.best_epoch))
        log.info(f"fold {fold}: best val AUC {tracker.best_auc:.4f} "
                 f"@ epoch {tracker.best_epoch}")
    return results


if __name__ == "__main__":
    main()
