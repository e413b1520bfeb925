"""Contrastive (retinal-COEM) training entry point (counterpart of
octcubem_tpu/cli/retclip.py).

    python -m octcubem_tpu_torch.cli.retclip --preset octcube_ir \\
        --synthetic --synthetic_n 80 --batch_size 8 --epochs 1
    python -m octcubem_tpu_torch.cli.retclip --data_dir tree_a \\
        --data_dir tree_b --save_retrieval_results
    python -m octcubem_tpu_torch.cli.retclip --model_config \\
        vitl16_octcube_ir_tiny_test --synthetic --device cpu --epochs 1

Parity target: retinal-COEM/src/training/main_retclip.py (SURVEY §3.3)
and main_retclip_3modalities.py: tower init from pretrained checkpoints,
LiT image-tower locking, the per-step cosine LR, the CLIP loss, a
retrieval eval each epoch on a patient-level held-out split,
results.jsonl and the retrieval pkl.  Every flag of the JAX CLI, with its
meaning, and the files it writes (``params.txt`` with the as-built tower
geometry, ``out.log``, ``results.jsonl``, ``tb/``, ``ckpt/{epoch}``,
``retrieval_results_{epoch}.pkl``).  ``--quant int8`` encodes with the
int8 towers and ``--aot`` with a frozen artifact (evaluation only);
``--export_aot`` writes the retrieval encoder as an artifact
(compat/aot.py, B1 as the custom op in its graph) and exits.

Runs on the card (``--device``, default cuda: every attention call runs
B1 forward and B2 backward) and refuses to start without one unless
given ``--device cpu``.  As in the JAX CLI, the host reads step t-1's
loss after it has issued step t.

Several cards: one process per card (``torchrun --nproc_per_node N -m
octcubem_tpu_torch.cli.retclip ...``).  A rank is the JAX CLI's host
with one device: ``--batch_size`` is per rank (rounded to the data axis
as JAX rounds it), the train loader strides over the mesh's data axis
(``core/mesh.cli_mesh(n_data, n_fsdp)``), and the CLIP loss spans the
global batch, its features gathered across ranks with their gradient
(train/clip_engine.py).  Every rank evaluates the whole held-out split,
so the retrieval metrics are the split's on every rank; rank 0 writes
the files and checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle

import numpy as np
import torch

class SyntheticPairs:
    """OCT volume + en face image pairs (+ FAF with presence weights),
    the JAX CLI's seeded draws (training/data.py:1036-1078)."""

    def __init__(self, n, frames, oct_size, enf_size, three_mod=False, seed=0):
        self.n, self.frames = n, frames
        self.oct_size, self.enf_size = oct_size, enf_size
        self.three_mod = three_mod
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng((self.seed, i))
        # paired samples share a latent pattern so retrieval can learn
        latent = rng.random((8, 8, 1), np.float32)
        up = np.kron(latent, np.ones((self.oct_size // 8, self.oct_size // 8,
                                      1), np.float32))
        vol = np.repeat(up[None], self.frames, axis=0) \
            + 0.1 * rng.random((self.frames, self.oct_size, self.oct_size, 1),
                               np.float32)
        upe = np.kron(latent, np.ones((self.enf_size // 8,
                                       self.enf_size // 8, 1), np.float32))
        enf = np.repeat(upe, 3, axis=-1) \
            + 0.1 * rng.random((self.enf_size, self.enf_size, 3), np.float32)
        if self.three_mod:
            faf = enf[::-1].copy()
            w = np.float32(rng.random() > 0.3)  # FAF present 70% of the time
            return vol.astype(np.float32), enf.astype(np.float32), faf, w
        return vol.astype(np.float32), enf.astype(np.float32)


class _Subset:
    def __init__(self, ds, idx):
        self.ds, self.idx = ds, list(idx)

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.ds[self.idx[i]]


def _split_train_val(ds, val_frac: float = 0.2, seed: int = 0):
    """Patient-level train/val split: all of a patient's visits go to the
    same side, so retrieval is measured on unseen patients.  Datasets
    without patient structure (synthetic) split by index."""
    records = getattr(ds, "records", None)
    if records is not None:
        pids = sorted({r.visit.patient_id for r in records})
        rng = np.random.default_rng(seed)
        n_val = max(1, int(len(pids) * val_frac))
        val_ids = set(np.asarray(pids)[rng.permutation(len(pids))[:n_val]])
        tr = [r for r in records if r.visit.patient_id not in val_ids]
        va = [r for r in records if r.visit.patient_id in val_ids]
        return (dataclasses.replace(ds, records=tr),
                dataclasses.replace(ds, records=va))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(ds))
    n_val = max(1, int(len(ds) * val_frac))
    return _Subset(ds, perm[n_val:]), _Subset(ds, perm[:n_val])


class RetrievalEncoder(torch.nn.Module):
    """A COEM model's feature forward, (image, enface[, enface2]) -> the
    normalized features, as a module (what ``--export_aot`` exports)."""

    def __init__(self, model, n_feat: int):
        super().__init__()
        self.model, self.n_feat = model, n_feat

    def forward(self, *xs):
        return tuple(self.model(*xs)[:self.n_feat])


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("OCTCube retclip training (PyTorch)")
    parser.add_argument("--preset", default="octcube_ir")
    parser.add_argument("--model_config", default=None,
                        help="COEM JSON config name/path (models/configs)")
    parser.add_argument("--data_dir", default=None, action="append",
                        help="paired OCT/IR(/FAF) tree (docs/DATA.md); "
                             "repeatable: the roots are concatenated "
                             "behind one loader (AggregatedPairedDataset)")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synthetic_n", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--evaluate_only", action="store_true")
    parser.add_argument("--save_retrieval_results", action="store_true")
    parser.add_argument("--resume", default=None,
                        help="'latest' restores the full TrainState from "
                             "output_dir/ckpt")
    parser.add_argument("--opt_chain", action="store_true",
                        help="recorded in params.txt for the JAX CLI, whose "
                             "legacy optax.chain layout it selects; here it "
                             "selects the same AdamW, since both layouts "
                             "compute the same update")
    parser.add_argument("--wandb", action="store_true",
                        help="log to Weights & Biases if installed; no-op "
                             "otherwise")
    parser.add_argument("--wandb_project_name", default="octcubem")
    parser.add_argument("--resume_params_only", action="store_true",
                        help="restore params only (fresh optimizer)")
    parser.add_argument("--quant", default="none", choices=["none", "int8"],
                        help="int8-quantize the tower encoders for "
                             "evaluation/export (ops/quant.py; training "
                             "always runs full precision)")
    parser.add_argument("--export_aot", default=None,
                        help="write a frozen retrieval-encoder artifact "
                             "(weights inside, honoring --quant) to this "
                             "path and exit")
    parser.add_argument("--aot", default=None,
                        help="with --evaluate_only: encode with a frozen "
                             "artifact from --export_aot instead of the "
                             "live model")
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    return parser


def _build(cfg, args, device, dtype, **kw):
    """The COEM model of the run (from --model_config or the preset's
    tower configs) on ``device`` with seeded weights."""
    from ..models import coem, registry

    if args.model_config:
        return registry.create_coem_model(args.model_config, dtype=dtype,
                                          device=device, seed=cfg.seed, **kw)
    cls = coem.COEP3Tower if cfg.three_mod else coem.COEP2Tower
    return coem.create_model(cls, device=device, seed=cfg.seed,
                             embed_dim=cfg.embed_dim,
                             vision_cfg=dict(cfg.vision_cfg),
                             enface_cfg=dict(cfg.enface_cfg), dtype=dtype,
                             **kw)


def main(argv=None):
    args = _parser().parse_args(argv)

    from ..compat.torch_import import (check_geometry_stamp,
                                       load_reference_weights,
                                       load_torch_checkpoint)
    from ..core import checkpoint as ckpt_lib, mesh as meshlib, multihost
    from ..core.config import RetClipConfig, load_config, to_json
    from ..core.device import resolve_device, to_device
    from ..data import loader as loader_lib
    from ..models import coem
    from ..train import clip_engine, optim, schedules
    from ..train.train_state import TrainState
    from ..utils.logging import (JsonlLogger, MetricLogger, TBWriter,
                                 Throughput, WandbWriter, get_logger)

    device = resolve_device(args.device)
    multihost.announce(device)
    main_rank = multihost.world()[0] == 0
    overrides = {k: v for k, v in (
        ("epochs", args.epochs), ("batch_size", args.batch_size),
        ("output_dir", args.output_dir), ("resume", args.resume))
        if v is not None}
    if args.evaluate_only:
        overrides["evaluate_only"] = True
    if args.opt_chain:
        overrides["opt_chain"] = True
    if args.resume_params_only:
        overrides["resume_params_only"] = True
    cfg = load_config(RetClipConfig, args.preset, **overrides)
    mesh = meshlib.cli_mesh(cfg.n_data, cfg.n_fsdp, device)
    os.makedirs(cfg.output_dir, exist_ok=True)
    log = get_logger("retclip", os.path.join(cfg.output_dir, "out.log"))
    dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
    model = _build(cfg, args, device, dtype, remat=cfg.grad_checkpointing)
    vcfg = model.vision_cfg or {}
    ecfg = model.enface_cfg or {}
    three_mod = isinstance(model, coem.COEP3Tower)
    # params.txt records the AS-BUILT tower geometry (with --model_config
    # the towers come from the JSON, not the preset): the resume check
    # below and the cls fine-tune's check_retclip_run_geometry trust it
    cfg = dataclasses.replace(
        cfg, model=(args.model_config or cfg.model),
        embed_dim=model.embed_dim, three_mod=three_mod,
        vision_cfg=dict(vcfg), enface_cfg=dict(ecfg))
    # the geometry guard runs BEFORE params.txt is overwritten: a
    # head-repartitioned tower would load cleanly and train a different
    # function
    if cfg.resume == "latest":
        from ..core.config import check_resume_geometry

        check_resume_geometry(
            cfg, os.path.join(cfg.output_dir, "params.txt"),
            ("model", "embed_dim", "three_mod", "vision_cfg", "enface_cfg"))
    if main_rank:
        with open(os.path.join(cfg.output_dir, "params.txt"), "w") as f:
            f.write(to_json(cfg))

    frames = vcfg.get("num_frames", 60)
    osize = vcfg.get("img_size", 256)
    esize = ecfg.get("img_size", 384)

    if args.data_dir:
        from ..data.multimodal import (AggregatedPairedDataset,
                                       PairedOCTEnfaceDataset,
                                       scan_paired_directory)

        sources = []
        for root in args.data_dir:
            d = PairedOCTEnfaceDataset(
                scan_paired_directory(root), num_frames=frames,
                oct_size=osize, enface_size=esize)
            if len(d) == 0:
                raise ValueError(
                    f"no paired OCT+IR visits found under {root} "
                    "(expected patient/visit dirs with oct_*.png + ir.png — "
                    "see docs/DATA.md)")
            sources.append(d)
        ds = (sources[0] if len(sources) == 1
              else AggregatedPairedDataset(sources))
    else:
        ds = SyntheticPairs(args.synthetic_n, frames, osize, esize, three_mod)

    # patient-level train/val split; aggregated data splits per source
    if args.data_dir and len(args.data_dir) > 1:
        halves = [_split_train_val(d, val_frac=0.2, seed=cfg.seed)
                  for d in ds.datasets]
        ds_train = AggregatedPairedDataset([h[0] for h in halves])
        ds_val = AggregatedPairedDataset([h[1] for h in halves])
    else:
        ds_train, ds_val = _split_train_val(ds, val_frac=0.2, seed=cfg.seed)
    log.info(f"train/val pairs: {len(ds_train)}/{len(ds_val)}")

    d_idx, n_data = meshlib.axis_coord(mesh, meshlib.DATA_AXIS)
    batch = max(n_data, (cfg.batch_size // n_data) * n_data)
    # feature-cached accumulation: the loader serves accum_freq chunks a
    # step, an effective batch of batch * accum_freq (per rank)
    accum = max(1, cfg.accum_freq)
    ld = loader_lib.Loader(ds_train, batch * accum, num_workers=4,
                           seed=cfg.seed, shard=(d_idx, n_data))
    # every rank evaluates the whole held-out split
    ld_eval = loader_lib.Loader(ds_val, batch, shuffle=False,
                                drop_last=False, num_workers=2, shard=(0, 1))

    def dev(a):
        return to_device(np.asarray(a, np.float32), device)

    def to_batch(items):
        if isinstance(items, dict):  # PairedOCTEnfaceDataset batches
            b = {k: dev(v) for k, v in items.items()
                 if k not in ("__key__", "label", "dataset_idx")}
            if not three_mod:
                return {"image": b["image"], "enface": b["enface1"]}
            return {"image": b["image"], "enface1": b["enface1"],
                    "enface2": b["enface2"], "weight1": b["weight1"],
                    "weight2": b["weight2"]}
        if three_mod:
            vol, enf, faf, w = items
            return {"image": dev(vol), "enface1": dev(enf),
                    "enface2": dev(faf),
                    "weight1": torch.ones(len(vol), device=device),
                    "weight2": dev(w)}
        vol, enf = items
        return {"image": dev(vol), "enface": dev(enf)}

    # tower init from pretrained reference checkpoints, the geometry
    # stamp checked first (a stamped enc8 .pth would load cleanly into a
    # 16-head tower)
    for ckpt_path, prefix, heads in (
            (cfg.visual_init_ckpt, "visual.trunk", vcfg.get("num_heads", 16)),
            (cfg.enface_init_ckpt, "enface.trunk",
             ecfg.get("num_heads", 16))):
        if ckpt_path:
            check_geometry_stamp(ckpt_path, heads)
            sd = {f"{prefix}.{k}": v
                  for k, v in load_torch_checkpoint(ckpt_path).items()}
            load_reference_weights(model, sd, strict=False,
                                   drop_keys=("head",))
            log.info(f"initialized {prefix} from {ckpt_path}")

    # LiT locking: the visual tower trains only its last
    # lock_image_unlocked_groups groups.  'partition' freezes for real (no
    # frozen backward, no frozen moments); 'zero_scale' zero-scales the
    # frozen params' updates
    trainable = dict(model.named_parameters())
    trainable_scales = None
    if cfg.lock_image and hasattr(model, "visual"):
        scales = optim.lit_lock_scales(model, vcfg.get("depth", 24),
                                       cfg.lock_image_unlocked_groups)
        if cfg.lock_mode == "zero_scale":
            trainable_scales = scales
        else:
            trainable = optim.make_partition(
                model, {k: s > 0 for k, s in scales.items()})
        n_frozen = sum(int(s == 0) for s in scales.values())
        log.info(f"LiT lock ({cfg.lock_mode}): {n_frozen} frozen param "
                 f"tensors, {cfg.lock_image_unlocked_groups} unlocked groups")

    steps_per_epoch = max(1, len(ld))
    sched = schedules.clip_cosine_lr(cfg.lr, cfg.warmup_steps,
                                     cfg.epochs * steps_per_epoch)
    # opt_chain selects the same AdamW (see its --help)
    tx = optim.build_adamw(trainable, sched, cfg.weight_decay,
                           betas=(0.9, 0.98))
    if trainable_scales is not None:
        optim.scale_by_tree(tx, trainable_scales)
    state = TrainState.create(model, tx, cfg.seed + 1)
    start_epoch = 0
    ckpt_dir = os.path.join(cfg.output_dir, "ckpt")
    from ..train.mae_engine import replicate_state, shard_batch, \
        shard_microbatch
    if cfg.resume == "latest" and ckpt_lib.latest_step(ckpt_dir) is not None:
        if cfg.resume_params_only:
            # params only, a fresh optimizer and epoch: works across
            # optimizer-layout and lock-mode changes
            raw_prev, step_prev = ckpt_lib.restore_raw(ckpt_dir)
            model.load_state_dict(raw_prev["params"], strict=True)
            log.info(f"params restored from {ckpt_dir} (step {step_prev}); "
                     "optimizer reset (resume_params_only)")
        else:
            try:
                state, extra, _ = ckpt_lib.restore_checkpoint(ckpt_dir, state)
            except (KeyError, ValueError, RuntimeError) as e:
                raise SystemExit(
                    f"resume failed against the current optimizer layout "
                    f"({e}).  Checkpoints written under a different lock "
                    f"configuration need a matching build (the saved run's "
                    f"lock_mode), or --resume_params_only to restore params "
                    f"with a fresh optimizer.") from e
            start_epoch = (extra or {}).get("epoch", 0) + 1
            log.info(f"resumed from epoch {start_epoch - 1}")

    state = replicate_state(state, mesh)

    # ---- the retrieval serving path: int8 encoders / AOT artifacts
    n_feat = 3 if three_mod else 2

    def _quant_encoder():
        """The towers rebuilt with QuantDense and the int8 conversion of
        the float weights (ops/quant.py)."""
        from ..ops.quant import quantize_state_dict

        qmodel = _build(cfg, args, device, dtype, quant=True)
        qmodel.load_state_dict(quantize_state_dict(model.state_dict()),
                               strict=True)
        return qmodel.eval()

    encode_fn = None
    if args.export_aot:
        from ..compat.aot import export_serving_artifact

        m_exp = _quant_encoder() if args.quant == "int8" else model.eval()
        ex = to_batch(next(iter(ld_eval)))
        names = (("image", "enface1", "enface2") if three_mod
                 else ("image", "enface"))
        export_serving_artifact(
            RetrievalEncoder(m_exp, n_feat), tuple(ex[k] for k in names),
            args.export_aot,
            meta={"kind": "coem_retrieval_encoder", "three_mod": three_mod,
                  "quant": args.quant, "embed_dim": cfg.embed_dim})
        log.info(f"retrieval encoder artifact written to {args.export_aot} "
                 f"({n_feat} features, quant={args.quant})")
        return args.export_aot
    if args.aot:
        from ..compat.aot import load_serving_artifact

        aot_fn, aot_meta = load_serving_artifact(args.aot, device)
        if bool(aot_meta.get("three_mod")) != three_mod:
            raise SystemExit(
                f"--aot artifact is three_mod={aot_meta.get('three_mod')} "
                f"but this run is three_mod={three_mod}")
        b_art = aot_meta["in_shapes"][0][0]

        def encode_fn(*xs):
            # the program's shapes are static: repeat-pad a short final
            # eval batch up to the artifact batch, truncate the features
            n = xs[0].shape[0]
            if n > b_art:
                raise SystemExit(
                    f"eval batch {n} exceeds the artifact batch {b_art}; "
                    "re-export with a larger batch or lower --batch_size")
            if n < b_art:
                xs = tuple(torch.cat([x] + [x[:1]] * (b_art - n))
                           for x in xs)
            return tuple(o[:n] for o in aot_fn(*xs))

        log.info(f"encoding with frozen artifact {args.aot} "
                 f"(quant={aot_meta.get('quant')})")
    elif args.quant == "int8":
        qmodel = _quant_encoder()

        def encode_fn(*xs):
            with torch.inference_mode():
                return qmodel(*xs)[:n_feat]

        log.info("encoding with live int8-quantized towers")
    if encode_fn is not None and not cfg.evaluate_only:
        raise SystemExit("--aot/--quant encoders are evaluation-only "
                         "(use --evaluate_only); training runs full "
                         "precision")

    if accum > 1:
        step_fn = (clip_engine.make_clip_accum_train_step_3mod(
                       model, tx, accum, mesh=mesh) if three_mod
                   else clip_engine.make_clip_accum_train_step(
                       model, tx, accum, mesh=mesh))
    else:
        step_fn = clip_engine.make_clip_train_step(model, tx,
                                                   three_mod=three_mod,
                                                   mesh=mesh)
    jsonl = JsonlLogger(cfg.output_dir, "results.jsonl")
    tb = TBWriter(os.path.join(cfg.output_dir, "tb"))
    wandb_w = WandbWriter(args.wandb, cfg.output_dir,
                          project=args.wandb_project_name,
                          name=os.path.basename(cfg.output_dir) or "retclip",
                          config=dataclasses.asdict(cfg))

    def eval_epoch(epoch):
        # one pass over the val loader: device batches for the features,
        # row-aligned keys harvested as we go
        save = args.save_retrieval_results or cfg.save_retrieval_results
        batches, keys = [], []
        for b in ld_eval:
            batches.append(to_batch(b))
            if isinstance(b, dict) and "__key__" in b:
                keys.extend(b["__key__"])
        result = clip_engine.evaluate_retrieval(
            model, batches, three_mod=three_mod, return_features=save,
            encode_fn=encode_fn)
        metrics, features = result if save else (result, None)
        jsonl.write({"epoch": epoch, **metrics})
        if save and main_rank:
            # the feature bank for the offline evaluator
            # (cli/retrieval_eval.py), with row-aligned keys and source
            # paths for its panels
            payload = {"metrics": metrics, **features}
            if keys:
                payload["keys"] = keys
                recs = (ds_val.key_to_record()
                        if hasattr(ds_val, "key_to_record") else
                        {f"{r.visit.patient_id}/{r.visit.visit_id}": r
                         for r in getattr(ds_val, "records", [])})
                payload["paths"] = {
                    k: {"oct": recs[k].visit.frames[0],
                        "enface1": recs[k].ir_path,
                        "enface2": recs[k].faf_path}
                    for k in keys if k in recs}
            with open(os.path.join(cfg.output_dir,
                                   f"retrieval_results_{epoch}.pkl"),
                      "wb") as f:
                pickle.dump(payload, f)
        return metrics

    if cfg.evaluate_only:
        m = eval_epoch(0)
        log.info(f"eval-only: {m}")
        wandb_w.finish()
        return m

    for epoch in range(start_epoch, cfg.epochs):
        ld.set_epoch(epoch)
        meter = MetricLogger()
        tput = Throughput()
        pending = None  # one step deep: step t-1's loss read after step t
        for items in meter.log_every(ld, 10, f"Epoch [{epoch}]", logger=log):
            b = to_batch(items)
            if accum > 1:
                b = shard_microbatch({k: v.reshape((accum, batch)
                                                   + v.shape[1:])
                                      for k, v in b.items()}, mesh)
            else:
                b = shard_batch(b, mesh)
            state, m = step_fn(state, b)
            if pending is not None:
                meter.update(loss=float(pending["loss"]))
            pending = m
            tput.update(batch * accum)
        if pending is not None:
            meter.update(loss=float(pending["loss"]))
        metrics = eval_epoch(epoch)
        if (epoch + 1) % cfg.save_frequency == 0:
            ckpt_lib.save_checkpoint(ckpt_dir, epoch, state,
                                     {"epoch": epoch},
                                     keep_last=cfg.keep_last,
                                     async_save=True)
        tb.scalar("train_loss", meter.meters["loss"].global_avg, epoch + 1)
        for mk, mv in metrics.items():
            if isinstance(mv, (int, float)):
                tb.scalar(mk, mv, epoch + 1)
        tb.flush()
        wandb_w.log({"train_loss": meter.meters["loss"].global_avg,
                     **metrics}, step=epoch + 1)
        r1 = metrics.get("image_to_enface_R@1",
                         metrics.get("image_to_enface1_R@1", 0))
        log.info(f"epoch {epoch}: loss "
                 f"{meter.meters['loss'].global_avg:.4f} "
                 f"{tput.rate:.1f} samples/s R@1 {r1:.3f}")
    ckpt_lib.wait_for_saves(ckpt_dir)
    wandb_w.finish()
    return state


if __name__ == "__main__":
    main()
