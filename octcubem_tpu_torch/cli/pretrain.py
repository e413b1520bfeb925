"""Joint 3D+2D MAE pretraining entry point (counterpart of
octcubem_tpu/cli/pretrain.py).

    python -m octcubem_tpu_torch.cli.pretrain --preset vitl_joint_pretrain \\
        --synthetic --synthetic_n 56 --batch_size 4 --epochs 2 \\
        --output_dir ./output_pretrain
    python -m octcubem_tpu_torch.cli.pretrain --synthetic --tiny \\
        --device cpu --epochs 1 --steps_per_epoch 2

Parity target: the full flow of Pre-training/
main_pretrain_oph_joint_2d512_flash_attn.py (SURVEY §3.1): joint 3D/2D
batches, blank-region pre-mask, SPL hardness updates + top-K reselection,
per-iteration cosine LR, per-epoch checkpoints and log.txt JSON-lines.
Every flag of the JAX CLI, with its meaning; the files a run writes
(``args.json``, ``log.txt``, ``all_image_dict-{epoch}.pkl``,
``ckpt/{epoch}``, ``profile/``) are the JAX CLI's.

Data: a directory of patient PNG stacks (data/patients.py convention) or
``--synthetic`` volumes, seeded as the JAX CLI's (a machine without PIL
runs ``--synthetic`` only).  Runs on the card (``--device``, default
cuda) and refuses to start without one unless given ``--device cpu``;
on the card every attention call runs the hand-written kernels (B1
forward, B2 backward).

Several cards: one process per card, e.g.

    torchrun --standalone --nproc_per_node 4 \
        -m octcubem_tpu_torch.cli.pretrain --preset vitl_joint_pretrain_sp4

A rank is the JAX CLI's host with one device: ``--batch_size`` is per
rank, the loaders stride over the mesh's data axis, and the LR scales
with ``eff_batch = batch * accum_iter * world`` (the JAX multi-host
formula, which counts the world even where ``n_fsdp`` or ``n_sp`` ranks
share rows).  The mesh is ``core/mesh.cli_mesh(n_data, n_fsdp, n_sp)``
over the group (``core/multihost.announce`` joins the launcher's); the
steps reduce their gradients over it (train/mae_engine.py).  ``n_sp`` > 1
forces ``attn_impl="flash_sp"`` under ``use_sequence_parallel(mesh, "sp",
batch_axis="data", shard_stacks=True)``: each stack shards its tokens
over the sp ranks (B5 / B7 on the card), as the JAX CLI's.  Rank 0 writes
the files and checkpoints; every rank restores.  The SPL update reads
this rank's rows (``local_rows``), as the JAX CLI's does, so the ranks'
hardness states and 2D batches diverge after the first epoch.

Each batch is loaded as numpy by the loader's worker threads and copied
to the card once, on the main thread, from pinned memory without a
host wait.  As in the JAX CLI, the host reads a step's results (the
loss, its finiteness, the SPL hardness) only after the next step is
issued, so the host never waits on the card inside the loop.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..core.device import resolve_device, to_device

# model-geometry fields that change the FUNCTION the params compute while
# leaving the param TREE identical (or cleanly interpolatable) — a resume
# under different values loads without error and silently trains a
# different model, so mismatches must fail loudly
_GEOMETRY_FIELDS = ("model", "num_heads", "decoder_num_heads",
                    "input_size", "high_res_input_size", "num_frames",
                    "t_patch_size", "pred_t_dim")

def _check_resume_geometry(cfg, prev_args_json: str) -> None:
    """Validate geometry-critical config fields against a prior run's
    args.json before resuming from it (core/config.check_resume_geometry
    with the MAE field list)."""
    from ..core.config import check_resume_geometry

    check_resume_geometry(cfg, prev_args_json, _GEOMETRY_FIELDS)


class SyntheticOCT3D:
    """Synthetic volumes; frame 'paths' reuse SyntheticOCT2D's names so
    the SPL frame-loss write-back path is exercised end to end."""

    def __init__(self, n, frames, size, seed=0, n_names=0):
        self.n, self.frames, self.size = n, frames, size
        self.seed = seed
        self.n_names = n_names

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng((self.seed, i))
        vol = rng.random((self.frames, self.size, self.size, 1), np.float32)
        names = tuple(
            f"img{(i * self.frames + t) % self.n_names}" if self.n_names
            else "" for t in range(self.frames))
        return vol.astype(np.float32), names, np.int64(0)


class SyntheticOCT2D:
    def __init__(self, n, t_patch, size, seed=0):
        self.n, self.t_patch, self.size = n, t_patch, size
        self.seed = seed
        self.names = [f"img{i}" for i in range(n)]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng((self.seed, i, 2))
        img = rng.random((1, self.size, self.size, 1), np.float32)
        frame = np.repeat(img, self.t_patch, axis=0)  # T = t_patch tube
        return frame, self.names[i]


def profile_window(n_steps: int, profile_steps: int) -> int:
    """The step at which the ``--profile_steps`` window opens: step 2,
    past the first steps' one-time costs, as in the JAX CLI; earlier when
    the epoch is too short to hold the window from there."""
    return min(2, max(0, n_steps - profile_steps))


def make_2d_step(model, tx, mesh=None):
    """-> step(state, batch) -> (state, loss, per_image): the plain 2D MAE
    update of ``_main_2d`` (mask 0.75, noise from ``state.generator``,
    the gradient of the mean loss, one AdamW update).  ``mesh``: the
    data-parallel reduction and noise rows of train/mae_engine.py."""
    from ..core import multihost
    from ..core.mesh import DATA_AXIS, axis_coord, check_mesh

    params = list(model.parameters())
    d_idx, n_d = axis_coord(mesh, DATA_AXIS)
    reduce = check_mesh(mesh)

    def step(state, batch):
        batch = multihost.local(batch)
        rows = batch.shape[0]
        noise = torch.rand((rows * n_d, model.grid ** 2),
                           generator=state.generator, device=batch.device)
        noise = noise[d_idx * rows:(d_idx + 1) * rows]
        model.train()
        loss, per_image, _, _ = model(batch, 0.75, noise)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        if reduce:
            grads = multihost.all_reduce_mean(grads)
            loss = multihost.all_reduce_mean([loss.detach()])[0]
        for p, g in zip(params, grads):
            p.grad = g
        tx.step()
        state.step += 1
        return state, loss.detach(), per_image.detach()

    return step


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("OCTCube MAE pretraining (PyTorch)")
    parser.add_argument("--preset", default="vitl_joint_pretrain")
    parser.add_argument("--data_dir", default=None)
    parser.add_argument("--kermany_dir", default=None,
                        help="Kermany-style image-folder tree added to the "
                             "2D SPL dataset (main_pretrain…py:313-330)")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--synthetic_n", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--steps_per_epoch", type=int, default=None)
    parser.add_argument("--accum_iter", type=int, default=None,
                        help="joint-step grad accumulation (both branches)")
    parser.add_argument("--accum_2d", type=int, default=None,
                        help="2D-branch-only microbatching (remat-free "
                             "joint fit; set 1 to disable the preset)")
    parser.add_argument("--decoder_num_heads", type=int, default=None,
                        help="MAE decoder heads: 16 = reference parity "
                             "(head_dim 32), 4 = head_dim 128 at the same "
                             "params (the vitl_mae_tpu_native preset)")
    parser.add_argument("--num_heads", type=int, default=None,
                        help="encoder heads: 16 = reference parity "
                             "(head_dim 64), 8 = head_dim 128.  UNLIKE the "
                             "decoder this changes the shipped encoder's "
                             "function — finetune/infer/serve must use the "
                             "same value")
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--resume", default=None,
                        help="'latest' or a prior run dir / ckpt dir")
    parser.add_argument("--resume_type", default=None,
                        help="see MAEPretrainConfig.resume_type")
    parser.add_argument("--init_ckpt", default=None)
    parser.add_argument("--load_spl_dir", default=None)
    parser.add_argument("--epoch_load_spl", type=int, default=None)
    parser.add_argument("--opt_chain", action="store_true", default=None,
                        help="recorded in args.json for the JAX CLI, whose "
                             "legacy optax.chain layout it selects; here it "
                             "selects the same AdamW, since both layouts "
                             "compute the same update")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny model dims for smoke runs")
    parser.add_argument("--eval_only", action="store_true",
                        help="reconstruction eval + image dumps only "
                             "(reference --eval_only, main_pretrain…py:573-592)")
    parser.add_argument("--mode", default="joint3d", choices=["joint3d", "2d"],
                        help="'2d' = plain 2D MAE pretraining with per-image "
                             "SPL hardness (OCTCube/main_pretrain_oph_new.py)")
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="capture a torch.profiler trace of this many "
                             "steps of the first epoch (from step 2, or "
                             "earlier in a shorter epoch) into "
                             "output_dir/profile/trace.json")
    parser.add_argument("--device", default=None,
                        help="default cuda; 'cpu' runs the plain path")
    return parser


def main(argv=None):
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)

    from ..core import multihost

    info = multihost.announce(device)
    if args.mode == "2d":
        return _main_2d(args, device)

    from ..core import checkpoint as ckpt_lib
    from ..core import mesh as meshlib
    from ..core.config import MAEPretrainConfig, load_config, to_json
    from ..data import loader as loader_lib, patients, spl as spl_lib
    from ..data import transforms
    from ..models import mae3d
    from ..train import mae_engine, optim, schedules
    from ..train.train_state import TrainState
    from ..utils import profiling
    from ..utils.logging import (JsonlLogger, MetricLogger, TBWriter,
                                 get_logger)

    overrides = {k: v for k, v in (
        ("epochs", args.epochs), ("batch_size", args.batch_size),
        ("output_dir", args.output_dir), ("resume", args.resume),
        ("resume_type", args.resume_type), ("init_ckpt", args.init_ckpt),
        ("load_spl_dir", args.load_spl_dir),
        ("epoch_load_spl", args.epoch_load_spl),
        ("accum_iter", args.accum_iter),
        ("accum_2d", args.accum_2d),
        ("decoder_num_heads", args.decoder_num_heads),
        ("num_heads", args.num_heads),
        ("opt_chain", args.opt_chain)) if v is not None}
    cfg = load_config(MAEPretrainConfig, args.preset, **overrides)
    mesh = meshlib.cli_mesh(cfg.n_data, cfg.n_fsdp, device, cfg.n_sp)
    os.makedirs(cfg.output_dir, exist_ok=True)
    log = get_logger("pretrain", os.path.join(cfg.output_dir, "out.log"))
    # geometry guard BEFORE args.json is overwritten: the param tree is
    # identical across head partitionings (and across several geometry
    # fields), so resuming under different flags would load cleanly and
    # silently train a DIFFERENT function — fail loudly instead
    if cfg.resume or cfg.resume_type == "resume_latest":
        prev_dir = (cfg.output_dir if cfg.resume in (None, "", "latest")
                    else cfg.resume)
        if os.path.basename(os.path.normpath(prev_dir)) == "ckpt":
            prev_dir = os.path.dirname(os.path.normpath(prev_dir))
        _check_resume_geometry(cfg, os.path.join(prev_dir, "args.json"))
    if multihost.world()[0] == 0:
        with open(os.path.join(cfg.output_dir, "args.json"), "w") as f:
            f.write(to_json(cfg))

    if args.tiny:
        model_kw = dict(input_size=32, high_res_input_size=64, embed_dim=64,
                        depth=2, num_heads=2, decoder_embed_dim=32,
                        decoder_depth=1, decoder_num_heads=2, num_frames=6,
                        t_patch_size=3, pred_t_dim=6)
    else:
        model_kw = dict(input_size=cfg.input_size,
                        high_res_input_size=cfg.high_res_input_size,
                        num_frames=cfg.num_frames,
                        t_patch_size=cfg.t_patch_size,
                        pred_t_dim=cfg.pred_t_dim,
                        norm_pix_loss=cfg.norm_pix_loss,
                        num_heads=cfg.num_heads,
                        decoder_num_heads=cfg.decoder_num_heads,
                        remat=cfg.remat)
    attn_impl = cfg.attn_impl
    if cfg.n_sp > 1 and attn_impl != "flash_sp":
        attn_impl = "flash_sp"  # n_sp opts the attention into sp
    dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
    # dispatch on cfg.model (base/large/huge constructors, mae3d registry;
    # mirrors the reference's models_mae.__dict__[args.model] dispatch,
    # Pre-training/main_pretrain_oph_joint_2d512_flash_attn.py:383)
    ctor = getattr(mae3d, cfg.model, None)
    if ctor is None or not callable(ctor):
        raise SystemExit(f"unknown MAE model '{cfg.model}' (expected a "
                         "constructor in octcubem_tpu_torch.models.mae3d, "
                         "e.g. mae_vit_large_patch16 / mae_vit_huge_patch14)")
    if args.tiny:
        ctor = mae3d.MaskedAutoencoderViT3D
    t_build = time.time()
    model = mae3d.create_model(ctor, device=device, seed=cfg.seed,
                               dtype=dtype, attn_impl=attn_impl,
                               **model_kw)
    log.info(f"model {ctor.__name__} built on {device} in "
             f"{time.time() - t_build:.2f} s")
    # joint-step memory mitigation precedence: an explicit remat_2d/remat
    # request wins over the preset's accum_2d default; accum_iter>1
    # already microbatches both branches so accum_2d folds into it
    accum_2d = max(1, cfg.accum_2d)
    use_remat_2d = cfg.remat_2d and not cfg.remat and not args.tiny
    if accum_2d > 1 and use_remat_2d:
        log.info("remat_2d=True set explicitly: disabling accum_2d="
                 f"{accum_2d} (rematerialization is the requested "
                 "mitigation)")
        accum_2d = 1
    if accum_2d > 1 and max(1, cfg.accum_iter) > 1:
        log.info("accum_iter>1 already microbatches the joint step; "
                 "disabling accum_2d")
        accum_2d = 1
    # the 2D branch through a remat graph over the same parameters
    model2d = model.with_remat() if use_remat_2d else None
    frames = model.num_frames
    size = model.input_size
    hi_size = model.high_res_input_size

    # ---- data
    if args.synthetic or args.data_dir is None:
        ds2d = SyntheticOCT2D(args.synthetic_n * 4, model.t_patch_size, hi_size)
        ds3d = SyntheticOCT3D(args.synthetic_n, frames, size,
                              n_names=len(ds2d.names))
    else:
        # real joint data (main_pretrain_oph_joint_2d512_flash_attn.py:
        # 313-355): 3D patient volumes + a 2D SPL dataset of the same
        # patients' frames plus an optional Kermany image folder
        visits = patients.scan_directory(args.data_dir, "*.png")
        _, label_fn = patients.build_labels(visits, "binary_cls")
        tr, _ = transforms.create_3d_transforms(size, frames)
        ds3d = patients.PatientDataset3D(visits, label_fn, max_frames=frames,
                                         transform=tr,
                                         return_frame_paths=True)
        ds2d = spl_lib.Pretrain2DDataset(
            visits=visits, kermany_root=args.kermany_dir, size=hi_size,
            t_patch=model.t_patch_size)
    spl_state = spl_lib.SPLState(getattr(ds2d, "names", []))
    d_idx, n_data = meshlib.axis_coord(mesh, meshlib.DATA_AXIS)

    def sp_ctx():
        # composed dp x sp: the stacks shard their tokens over the mesh's
        # sp axis with the batch split over 'data' (parallel/sequence.py)
        import contextlib

        if cfg.n_sp <= 1:
            return contextlib.nullcontext()
        from ..parallel.sequence import use_sequence_parallel

        return use_sequence_parallel(mesh, meshlib.SP_AXIS,
                                     batch_axis=meshlib.DATA_AXIS,
                                     shard_stacks=True)

    def _round_to_mesh(b: int, n_items: int) -> int:
        b = min(b, n_items)  # never a batch larger than the dataset
        if n_items < n_data:
            raise ValueError(
                f"dataset has {n_items} items but the mesh needs a batch "
                f"divisible by {n_data} devices")
        return max(n_data, (b // n_data) * n_data)

    accum = max(1, cfg.accum_iter)
    batch3d = _round_to_mesh(cfg.batch_size, len(ds3d) // accum)
    # the 2D loader serves the SPL-active (top-K hardest) subset, a live
    # view that update_spl() reshapes each epoch (ref main:673-687); the
    # batch is sized for the smallest K so its shape holds every epoch
    min_active = max(1, int(len(ds2d) * cfg.spl_k_min))
    batch2d = _round_to_mesh(cfg.batch_size_2d, min_active // accum)
    if accum_2d > 1:
        # when the (dataset-capped) batch is too small to split, collapse
        # the factor instead of inflating the batch (tiny/synthetic runs)
        accum_2d = max(1, min(accum_2d, batch2d // n_data))
        batch2d = batch2d // (accum_2d * n_data) * (accum_2d * n_data)
    ds2d_active = spl_state.subset(ds2d)
    # accum_iter > 1: the loaders serve accum microbatches per step
    # (the engine averages their gradients into one update); each rank
    # loads its stride of the data axis (batch sizes are PER RANK)
    shard = (d_idx, n_data)
    ld3 = loader_lib.Loader(ds3d, batch3d * accum, num_workers=4,
                            shard=shard)
    ld2 = loader_lib.Loader(ds2d_active, batch2d * accum, num_workers=2,
                            shard=shard)
    loader2_iter = loader_lib.cycle(ld2)
    assert len(ld3) > 0, "empty train loader (batch larger than dataset?)"
    # effective batch spans all ranks: loader batch_size is PER RANK
    # (reference eff_batch_size = batch * accum_iter * world_size,
    # main_pretrain_oph_joint_2d512_flash_attn.py)
    eff_batch = batch3d * accum * info["process_count"]
    lr = schedules.scale_base_lr(cfg.blr, eff_batch)
    steps_per_epoch = args.steps_per_epoch or max(1, len(ld3))
    sched = schedules.warmup_half_cosine(lr, cfg.min_lr, cfg.warmup_epochs,
                                         cfg.epochs, steps_per_epoch)
    # opt_chain selects the same AdamW (see its --help)
    tx = optim.build_adamw(model, sched, cfg.weight_decay,
                           clip_grad=cfg.clip_grad)
    state = TrainState.create(model, tx, seed=cfg.seed + 1)
    shard_batch, shard_microbatch = (mae_engine.shard_batch,
                                     mae_engine.shard_microbatch)

    # resume-type dispatch (reference main_pretrain…py:457-571, 7 types):
    #   training_new          fresh params (optionally init_ckpt as-is)
    #   resume_latest         restore the full TrainState from output_dir
    #                         + SPL dict reload (ref main:469-489)
    #   retfound_2_flash_attn RETFound 2D ckpt -> joint 3D MAE
    #   imagenet_mae          timm MAE 2D ckpt (ref imagenet_2_flash_attn)
    #   imagenet_ft           timm supervised-ft 2D ckpt — same converter
    #                         chain, classifier head/pre_logits dropped
    #                         (ref imagenet_ft_2_flash_attn, main:525-534)
    #   training_continue_reset_optim  params from a prior run's ckpt,
    #                         FRESH optimizer + epoch 0, optional SPL dict
    #                         from load_spl_dir (ref main:535-546)
    #   octcube / released    flash-style 3D ckpt loaded directly
    start_epoch = 0
    ckpt_dir = os.path.join(cfg.output_dir, "ckpt")
    _IMAGENET_FT = ("imagenet_ft", "imagenet_ft_2_flash_attn")

    def _reload_spl(path: str, epoch: int) -> None:
        # mutate in place: ds2d_active holds a live view of spl_state
        spl_state.hardness = spl_lib.SPLState.load(path).hardness
        k0 = schedules.spl_k_schedule(epoch, cfg.spl_k_max, cfg.spl_k_min,
                                      cfg.epochs, cfg.warmup_epochs)
        spl_state.update_spl(k0)
        log.info(f"SPL dict reloaded from {path} (K={k0:.2f})")

    if cfg.init_ckpt:
        from ..compat.torch_import import (check_geometry_stamp,
                                           convert_retfound_2d_state_dict,
                                           import_state_dict,
                                           load_torch_checkpoint)

        # stamped exports from a head-repartitioned run load cleanly into
        # any partitioning and silently train the wrong function — refuse
        # on mismatch (reference checkpoints are unstamped: no-op)
        check_geometry_stamp(cfg.init_ckpt, cfg.num_heads,
                             decoder_num_heads=cfg.decoder_num_heads)
        sd = load_torch_checkpoint(cfg.init_ckpt)
        if cfg.resume_type in (
                "retfound_2_flash_attn", "imagenet_mae") + _IMAGENET_FT:
            sd = convert_retfound_2d_state_dict(
                sd, model.t_patch_size, model.high_res_grid)
        # supervised-ft checkpoints carry a classifier head (and the in21k
        # variants a pre_logits block) with no MAE slot; the reference's
        # strict=False load discards them silently — drop explicitly here
        drop = (("head.weight", "head.bias", "pre_logits")
                if cfg.resume_type in _IMAGENET_FT else ())
        merged, rep = import_state_dict(model, sd, strict=False,
                                        drop_keys=drop)
        model.load_state_dict(merged, strict=True)
        log.info(f"init from {cfg.init_ckpt} ({cfg.resume_type}); "
                 f"fresh params: {len(rep['missing'])}")
    if cfg.resume_type == "training_continue_reset_optim" and not cfg.resume:
        # fail loudly: without --resume there is nothing to continue from
        # and the run would silently train fresh params
        raise SystemExit(
            "resume_type=training_continue_reset_optim requires --resume "
            "(the run/ckpt dir whose params to continue)")
    if cfg.resume_type == "training_continue_reset_optim" and cfg.resume:
        # 'latest' resolves to THIS run's output dir (continue own params
        # with a fresh optimizer); anything else is a prior run/ckpt dir
        prev = cfg.output_dir if cfg.resume == "latest" else cfg.resume
        if os.path.basename(os.path.normpath(prev)) != "ckpt":
            prev = os.path.join(prev, "ckpt")
        # restore RAW: only params are wanted, and the prior run's
        # optimizer state need not match this run's optimizer
        raw_prev, step_prev = ckpt_lib.restore_raw(prev)
        model.load_state_dict(raw_prev["params"], strict=True)
        log.info(f"params restored from {prev} (step {step_prev}); "
                 "optimizer reset, epochs restart at 0")
        if cfg.epoch_load_spl >= 0 and cfg.load_spl_dir:
            spl_path = os.path.join(
                cfg.load_spl_dir,
                f"all_image_dict-{cfg.epoch_load_spl}.pkl")
            if os.path.exists(spl_path):
                _reload_spl(spl_path, 0)
    elif cfg.resume or cfg.resume_type == "resume_latest":
        # --resume accepts 'latest' (this run's output_dir) or a prior
        # run / ckpt dir (reference --resume path, util/misc.py:344-363)
        resume_dir = ckpt_dir
        if cfg.resume and cfg.resume != "latest":
            resume_dir = cfg.resume
            if os.path.basename(os.path.normpath(resume_dir)) != "ckpt":
                resume_dir = os.path.join(resume_dir, "ckpt")
            if ckpt_lib.latest_step(resume_dir) is None:
                raise SystemExit(f"--resume {cfg.resume}: no checkpoints "
                                 f"found under {resume_dir}")
        if ckpt_lib.latest_step(resume_dir) is not None:
            # in place: params, AdamW count and moments, step, generator
            state, extra, step = ckpt_lib.restore_checkpoint(resume_dir,
                                                             state)
            start_epoch = (extra or {}).get("epoch", 0) + 1
            log.info(f"resumed from {resume_dir} epoch {start_epoch - 1}")
            spl_dir = (cfg.resume if cfg.resume not in ("", "latest")
                       else cfg.output_dir)
            spl_path = os.path.join(spl_dir,
                                    f"all_image_dict-{start_epoch - 1}.pkl")
            if os.path.exists(spl_path):
                _reload_spl(spl_path, start_epoch)
    # every rank built and restored the same state; rank 0's is the one
    # (as the JAX CLI re-places its restored state on the mesh)
    state = mae_engine.replicate_state(state, mesh)

    step_fn = mae_engine.make_mae_train_step(
        model, tx, joint=True, use_premask=cfg.use_premask,
        accum_iter=accum, model2d=model2d, accum_2d=accum_2d, mesh=mesh)
    jsonl = JsonlLogger(cfg.output_dir)
    tb = TBWriter(os.path.join(cfg.output_dir, 'tb'))

    if args.eval_only:
        # reconstruction eval with image dumps (engine_pretrain.py:282-338)
        from ..utils.visualization import reconstruction_panels, save_recon_grid

        eval_fn = mae_engine.make_mae_eval_step(model)
        losses = []
        for it, (vols, _, _) in enumerate(ld3):
            b3 = to_device(vols, device)
            gen = torch.Generator(device=device).manual_seed(it)
            with sp_ctx():
                out = eval_fn(b3, generator=gen)
            losses.append(float(out["loss"]))
            if it == 0 and multihost.world()[0] == 0:
                mask_np = multihost.local_rows(out["mask"].float())
                panels = reconstruction_panels(
                    multihost.local_rows(b3),
                    multihost.local_rows(out["pred"].float()),
                    mask_np, model.t_pred_patch_size,
                    model.patch_size,
                    (mask_np.shape[1]
                     // model.grid ** 2, model.grid, model.grid))
                path = save_recon_grid(panels, cfg.output_dir, "eval")
                log.info(f"recon dump: {path}")
        log.info(f"eval loss: {np.mean(losses):.4f}")
        jsonl.write({"eval_loss": float(np.mean(losses))})
        return None

    for epoch in range(start_epoch, cfg.epochs):
        mask2d = schedules.mask_ratio_2d_schedule(
            epoch, cfg.mask_ratio_2d_min, cfg.mask_ratio_2d_max,
            cfg.epochs, cfg.warmup_epochs)
        ld3.set_epoch(epoch)
        meter = MetricLogger()
        t0 = time.time()

        def consume(metrics, fpaths, it):
            # host-side reads of a PREVIOUS step's results: loss
            # finiteness, SPL hardness, meters.  Deferring these one step
            # keeps the host issuing the next step while the card runs
            # this one (the .item() / host copies are the sync points).
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                # delete recent checkpoints so a resume restarts from a
                # pre-divergence state (engine_pretrain.py:153-161)
                deleted = ckpt_lib.delete_recent_checkpoints(ckpt_dir, 2)
                log.info(f"removed checkpoints {deleted} after NaN")
                raise RuntimeError(f"Loss is {loss}, stopping training")
            # SPL hardness: the 3D batch's per-tube frame losses are
            # written into the frame-keyed 2D hardness dict
            # (engine_pretrain.py:133-146) — NOT the 2D batch's names
            frame_losses = multihost.local_rows(metrics["frame_losses"])
            vol_paths = list(zip(*fpaths))
            assert len(vol_paths) == frame_losses.shape[0], (
                len(vol_paths), frame_losses.shape)
            spl_state.update_from_volume_losses(
                vol_paths, frame_losses, model.t_patch_size)
            meter.update(loss=loss, loss_3d=float(metrics["loss_3d"]),
                         loss_2d=float(metrics["loss_2d"]),
                         grad_norm=float(metrics["grad_norm"]))
            # epoch_1000x pseudo-step (engine_pretrain.py:177-198)
            tb.scalar("train_loss", loss, epoch + it / steps_per_epoch)

        pending = None  # one-step-deep pipeline: (metrics, fpaths, it)
        prof = None
        prof_start = profile_window(min(steps_per_epoch, len(ld3)),
                                    args.profile_steps)
        for it, (vols, fpaths, _) in enumerate(
                meter.log_every(ld3, 10, f"Epoch [{epoch}]", logger=log)):
            if args.steps_per_epoch and it >= args.steps_per_epoch:
                break
            if args.profile_steps and epoch == start_epoch:
                # consume pending first so the traced window closes on a
                # host sync, not mid-issue
                if it == prof_start:
                    prof = profiling.profiler(
                        os.path.join(cfg.output_dir, "profile"))
                    prof.start()
                elif prof is not None and (
                        it == prof_start + args.profile_steps):
                    if pending is not None:
                        consume(*pending)
                        pending = None
                    prof.stop()
                    prof = None
                    log.info("profiler trace written to "
                             f"{cfg.output_dir}/profile")
            imgs2d, _ = next(loader2_iter)
            b3 = to_device(vols, device)
            b2 = to_device(imgs2d, device)
            # this rank's rows placed as the JAX CLI places the global
            # batch: [accum, micro] with the micro axis sharded
            if accum > 1:
                b3 = shard_microbatch(
                    b3.reshape((accum, batch3d) + b3.shape[1:]), mesh)
                b2 = shard_microbatch(
                    b2.reshape((accum, batch2d) + b2.shape[1:]), mesh)
            elif accum_2d > 1:
                # 2D-branch-only microbatching (remat-free joint fit)
                b3 = shard_batch(b3, mesh)
                b2 = shard_microbatch(
                    b2.reshape((accum_2d, batch2d // accum_2d)
                               + b2.shape[1:]), mesh)
            else:
                b3, b2 = shard_batch(b3, mesh), shard_batch(b2, mesh)
            # the blank-region pre-mask is computed inside the step
            # (use_premask), from the patch embeddings it computes once
            with sp_ctx():
                state, metrics = step_fn(
                    state, b3, mask_ratio=cfg.mask_ratio, batch2d=b2,
                    mask_ratio_2d=round(mask2d, 4))
            if pending is not None:
                consume(*pending)
            pending = (metrics, fpaths, it)
        if pending is not None:
            consume(*pending)
        if prof is not None:  # epoch shorter than the requested window
            prof.stop()
            log.info(f"profiler trace written to {cfg.output_dir}/profile")
        k = schedules.spl_k_schedule(epoch, cfg.spl_k_max, cfg.spl_k_min,
                                     cfg.epochs, cfg.warmup_epochs)
        spl_state.update_spl(k)
        if multihost.world()[0] == 0:
            spl_state.save(cfg.output_dir, epoch)
        # async: the multi-GB state write overlaps the next epoch (the
        # host copies are staged before it returns)
        t_save = time.time()
        ckpt_lib.save_checkpoint(ckpt_dir, epoch, state, {"epoch": epoch},
                                 keep_last=3, async_save=True)
        log.info(f"checkpoint {epoch} staged in {time.time() - t_save:.2f} s")
        jsonl.write({"epoch": epoch,
                     "train_loss": meter.meters["loss"].global_avg,
                     "lr": float(sched(state.step)),
                     "epoch_time_s": time.time() - t0,
                     "spl_k": k, "mask_ratio_2d": mask2d})
        tb.scalar("lr", float(sched(state.step)), epoch + 1)
        tb.scalar("spl_k", k, epoch + 1)
        tb.flush()
        log.info(f"epoch {epoch} done: {meter}")
    ckpt_lib.wait_for_saves(ckpt_dir)
    log.info("pretraining complete")
    return state


def _main_2d(args, device):
    """Plain 2D MAE pretraining with per-image SPL hardness tracking
    (OCTCube/main_pretrain_oph_new.py + engine_pretrain.py:96-168)."""
    from ..core import checkpoint as ckpt_lib, mesh as meshlib, multihost
    from ..data import loader as loader_lib, spl as spl_lib
    from ..models import mae2d
    from ..train import optim, schedules
    from ..train.train_state import TrainState
    from ..utils.logging import JsonlLogger, MetricLogger, get_logger

    out_dir = args.output_dir or "./output_pretrain2d"
    os.makedirs(out_dir, exist_ok=True)
    log = get_logger("pretrain2d", os.path.join(out_dir, "out.log"))
    size = 32 if args.tiny else 224
    t_build = time.time()
    if args.tiny:
        model = mae2d.create_model(
            mae2d.MaskedAutoencoderViT2D, device=device, seed=0,
            img_size=size, patch_size=16, in_chans=1, embed_dim=32, depth=2,
            num_heads=2, decoder_embed_dim=16, decoder_depth=1,
            decoder_num_heads=2, attn_impl="auto")
    else:
        model = mae2d.create_model(mae2d.mae_vit_large_patch16,
                                   device=device, seed=0, img_size=size,
                                   in_chans=1, dtype=torch.bfloat16)
    log.info(f"2D model built on {device} in {time.time() - t_build:.2f} s")

    class Synth2D:
        names = [f"img{i}" for i in range(args.synthetic_n * 4)]

        def __len__(self):
            return len(self.names)

        def __getitem__(self, i):
            rng = np.random.default_rng((7, i))
            return (rng.random((size, size, 1), np.float32), self.names[i])

    if args.data_dir and not args.synthetic:
        # real 2D data: in-house frame tree and/or a Kermany-style image
        # folder (OCTCube/main_pretrain_oph_new.py / main_pretrain.py)
        from ..data import patients

        visits = (patients.scan_directory(args.data_dir, "*.png")
                  if args.data_dir else [])
        ds = spl_lib.Pretrain2DDataset(
            visits=visits, kermany_root=args.kermany_dir, size=size,
            as_tube=False)
    else:
        ds = Synth2D()
    spl_state = spl_lib.SPLState(ds.names)
    mesh = meshlib.cli_mesh(device=device)
    # the JAX CLI's batch here is per host and rounds to its local data
    # axis, which is one card a rank
    batch = args.batch_size or 16
    ld = loader_lib.Loader(ds, batch, num_workers=2,
                           shard=meshlib.axis_coord(mesh, meshlib.DATA_AXIS))
    sched = schedules.warmup_half_cosine(1.5e-4 * batch / 256, 0.0, 2,
                                         args.epochs or 10, max(1, len(ld)))
    tx = optim.build_adamw(model, sched, 0.05)
    state = TrainState.create(model, tx, seed=1)
    from ..train.mae_engine import replicate_state

    state = replicate_state(state, mesh)
    step = make_2d_step(model, tx, mesh)

    jsonl = JsonlLogger(out_dir)
    ckpt_dir = os.path.join(out_dir, "ckpt")
    for epoch in range(args.epochs or 2):
        ld.set_epoch(epoch)
        meter = MetricLogger()
        for imgs, names in meter.log_every(ld, 10, f"2D Epoch [{epoch}]",
                                           logger=log):
            b = to_device(imgs, device)
            state, loss, per_image = step(state, b)
            spl_state.update_hardness(list(names),
                                      multihost.local_rows(per_image))
            meter.update(loss=float(loss))
        k = schedules.spl_k_schedule(epoch, total_epochs=args.epochs or 2,
                                     warmup_epochs=1)
        spl_state.update_spl(k)
        if multihost.world()[0] == 0:
            spl_state.save(out_dir, epoch)
        ckpt_lib.save_checkpoint(ckpt_dir, epoch, state, {"epoch": epoch},
                                 keep_last=2, async_save=True)
        jsonl.write({"epoch": epoch,
                     "train_loss": meter.meters["loss"].global_avg})
        log.info(f"2d epoch {epoch}: {meter}")
    ckpt_lib.wait_for_saves(ckpt_dir)
    return state


if __name__ == "__main__":
    main()
