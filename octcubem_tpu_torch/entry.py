"""Entry points: the spatiotemporal classifier forward (counterpart of
``__graft_entry__.entry()``), the 3D MAE pretraining step (the
configuration of ``bench.py::measure``), each for a model constructor of
the registry (ViT-L/16 by default, ViT-H/14 through ``ctor``), and
``dryrun_multichip(n)``, every multi-rank path on n ranks (counterpart of
``__graft_entry__.dryrun_multichip``)."""

from __future__ import annotations

import functools
import json
import math
import os
import shutil
import tempfile
import time

import torch

from .models import mae3d, vit_st
from .train import mae_engine, optim, schedules
from .train.train_state import TrainState


def entry(device=None, ctor=vit_st.flash_attn_vit_large_patch16,
          img_size: int = 256, **model_kw):
    """-> (fn, (model, x)): ``fn(model, x)`` is the bf16 inference forward
    of the released OCTCube classifier config (dropout head, global pool,
    separable pos embeds) on one 48 x ``img_size`` x ``img_size`` volume of
    ones.  Default: ViT-L/16 at 256, 4,096 tube tokens plus cls; with
    ``ctor=vit_st.vit_huge_patch14, img_size=224``, ViT-H/14 (16 heads of
    80) at the same 4,096 + cls.  Weights are seeded random; ``model_kw``
    overrides model arguments (e.g. depth).  Runs on the card unless
    ``device="cpu"``."""
    kw = dict(num_frames=48, t_patch_size=3, img_size=img_size, in_chans=1,
              num_classes=16, head_type="dropout", global_pool=True,
              sep_pos_embed=True, cls_embed=True, dtype=torch.bfloat16,
              attn_impl="auto")
    kw.update(model_kw)
    model = vit_st.create_model(ctor, device=device, seed=0, **kw)
    x = torch.ones((1, kw["num_frames"], img_size, img_size, 1),
                   dtype=torch.float32, device=model.head.weight.device)

    def fn(model, x):
        with torch.inference_mode():
            return model(x)

    return fn, (model, x)


def train_entry(device=None, dec_heads: int = 16, batch: int = 4,
                ctor=mae3d.mae_vit_large_patch16, input_size: int = 256,
                joint: bool = False, batch2d: int = 64, accum_2d: int = 1,
                use_premask: bool = False, remat_2d: bool = False,
                **model_kw):
    """-> (step, state, x): ``step(state, x, mask_ratio=0.9)`` is one MAE
    pretraining step (forward, backward, fused AdamW) of ``ctor``'s 3D MAE
    at full width and depth, with a decoder 512 wide, 8 blocks,
    ``dec_heads`` heads (16 of 32, the reference geometry, or 4 of 128);
    bf16 compute with fp32 params; the spatial pos embeds stored at twice
    ``input_size``.  Default: ViT-L/16 (1024 wide, 24 blocks, 16 heads of
    64) at 256; with ``ctor=mae3d.mae_vit_huge_patch14, input_size=224``,
    ViT-H/14 (1280 wide, 32 blocks, 16 heads of 80).  AdamW betas (0.9,
    0.95), weight decay 0.05, LR warmup_half_cosine(1.6e-3, 0, 1, 50,
    1000).  x is ``batch`` seeded-normal 60 x ``input_size`` x
    ``input_size`` volumes; weights are seeded random.  ``model_kw``
    overrides model arguments (e.g. depth, decoder_depth).

    ``joint=True`` is the ``vitl_joint_pretrain`` step: each step adds the
    MAE loss of ``batch2d`` seeded-normal 2D images (3 frames, one tube,
    at twice ``input_size``: 1,024 tokens each at 512 and patch 16) at
    mask 0.75, bound into the returned step (its ``batch2d`` keyword),
    laid out [accum_2d, batch2d / accum_2d, ...] when ``accum_2d`` > 1;
    ``use_premask`` computes the blank-region pre-mask in the step;
    ``remat_2d`` runs the 2D branch through ``model.with_remat()``.  Runs
    on the card unless ``device="cpu"``."""
    kw = dict(decoder_embed_dim=512, decoder_depth=8, num_frames=60,
              t_patch_size=3, pred_t_dim=60, input_size=input_size,
              high_res_input_size=2 * input_size, in_chans=1,
              dtype=torch.bfloat16, attn_impl="auto", num_heads=16,
              decoder_num_heads=dec_heads)
    kw.update(model_kw)
    model = mae3d.create_model(ctor, device=device, seed=1, **kw)
    dev = model.cls_token.device
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((batch, kw["num_frames"], input_size, input_size, 1),
                    generator=gen, device=dev)
    sched = schedules.warmup_half_cosine(1.6e-3, 0.0, 1, 50, 1000)
    tx = optim.build_adamw(model, sched, weight_decay=0.05)
    state = TrainState.create(model, tx, seed=2)
    step = mae_engine.make_mae_train_step(
        model, tx, joint=joint, use_premask=use_premask, accum_2d=accum_2d,
        model2d=model.with_remat() if remat_2d else None)
    if joint:
        if batch2d % accum_2d:
            raise ValueError(f"batch2d {batch2d} is not a multiple of "
                             f"accum_2d {accum_2d}")
        size = kw["high_res_input_size"]
        shape = (batch2d, kw["t_patch_size"], size, size, 1)
        if accum_2d > 1:
            shape = (accum_2d, batch2d // accum_2d) + shape[1:]
        x2 = torch.randn(shape, generator=gen, device=dev)
        step = functools.partial(step, batch2d=x2, mask_ratio_2d=0.75)
    return step, state, x


# ------------------------------------------------------- dryrun_multichip

# seconds before dryrun_multichip stops ranks that have not finished
_DRYRUN_TIMEOUT_S = 1200.0

def _dryrun_setup(n: int, device) -> tuple[str, str, str]:
    """-> (device type, backend, how the ranks sit): NCCL with a card a
    rank when n cards are present, else gloo ranks sharing the cards;
    gloo on the CPU only when ``device`` asks for it."""
    from .core.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu", "gloo", f"{n} CPU processes"
    cards = torch.cuda.device_count()
    if cards >= n:
        return "cuda", "nccl", f"{n} cards, one a rank"
    return "cuda", "gloo", (f"{n} gloo ranks sharing {cards} card(s) "
                            f"(NCCL takes one rank a card)")


def dryrun_multichip(n_devices: int, device=None) -> list[str]:
    """Start ``n_devices`` ranks (spawned processes in one process group)
    and run the JAX package's multi-chip legs on them, in its order, at
    its sizes: the joint MAE step on a data x fsdp mesh on a state sharded
    by ``fsdp_param_spec``, the CLIP step on such a state, a dp x sp stack
    (16 * n_sp + 1 tokens, through the ``kv_valid`` pad), ring attention,
    and tp over ``n_devices`` heads; then the ViT-L-width joint step
    (encoder depth 2, decoder depth 1, 60 x 256^2 with the 512^2 2D
    branch) through the flash kernels on the data x fsdp mesh of the first
    leg (2 x 2 at four ranks), asserting that the policy shards at least
    three classes of tensor.  Prints one line per leg and returns them.

    The backend is explicit: NCCL when ``n_devices`` cards are present,
    else gloo ranks sharing the card (NCCL refuses two ranks on one
    device); the CPU (gloo) only with ``device="cpu"``.  A leg that fails
    or gives a non-finite value fails the call: a rank's error ends the
    run with every rank stopped."""
    import torch.multiprocessing as mp

    dev_type, backend, where = _dryrun_setup(n_devices, device)
    tmp = tempfile.mkdtemp(prefix="dryrun_multichip_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dryrun_rank,
                         args=(r, n_devices, tmp, dev_type, backend))
             for r in range(n_devices)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + _DRYRUN_TIMEOUT_S
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs) if p.exitcode not in
                   (None, 0)]
            if bad or time.monotonic() > deadline:
                raise RuntimeError(
                    f"dryrun_multichip({n_devices}): ranks {bad} failed "
                    f"(exit codes {[p.exitcode for p in procs]})" if bad
                    else f"dryrun_multichip({n_devices}): not done in "
                    f"{_DRYRUN_TIMEOUT_S:.0f} s")
            time.sleep(0.2)
        codes = [p.exitcode for p in procs]
        if codes != [0] * n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank exit "
                               f"codes {codes}")
        with open(os.path.join(tmp, "lines.json")) as f:
            lines = [f"dryrun_multichip({n_devices}): {where}, backend "
                     f"{backend}"] + json.load(f)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    for line in lines:
        print(line)
    return lines


def _finite(what: str, *tensors) -> None:
    for t in tensors:
        if t is not None and not torch.isfinite(t).all():
            raise AssertionError(f"{what}: non-finite values")


def _class_name(name: str) -> str:
    """A param's tensor class: its module's name for a weight or bias
    (``blocks.0.mlp.fc1.weight`` -> fc1), else its own."""
    parts = name.split(".")
    if parts[-1] in ("weight", "bias") and len(parts) >= 2:
        return parts[-2]
    return parts[-1]


def _dryrun_rank(rank: int, n: int, tmp: str, dev_type: str,
                 backend: str) -> None:
    """One rank of ``dryrun_multichip``: joins the group, runs the legs,
    and rank 0 writes their lines to ``tmp``/lines.json."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from .core import fsdp, multihost
    from .core.mesh import fsdp_param_spec, make_mesh
    from .models import coem
    from .nn.layers import TransformerStack
    from .parallel.sequence import ring_attention, use_sequence_parallel
    from .parallel.tensor import shard_tp_params, use_tensor_parallel
    from .train import clip_engine

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    multihost.initialize(store=dist.FileStore(os.path.join(tmp, "store"), n),
                         world_size=n, rank=rank, backend=backend,
                         device=dev_type, timeout_s=600)
    try:
        dev = torch.device(dev_type, torch.cuda.current_device()) \
            if dev_type == "cuda" else torch.device("cpu")
        lines = []
        n_fsdp = 2 if n % 2 == 0 else 1
        n_data = n // n_fsdp
        mesh = make_mesh(n_data, n_fsdp, device=dev_type)
        sched = schedules.warmup_half_cosine(1.6e-3, 0.0, 1, 10, 100)

        # 1. the joint MAE step, batch over data, params over fsdp
        model = mae3d.create_model(
            mae3d.MaskedAutoencoderViT3D, device=dev, seed=0, input_size=32,
            high_res_input_size=64, patch_size=16, in_chans=1, embed_dim=64,
            depth=2, num_heads=2, decoder_embed_dim=32, decoder_depth=1,
            decoder_num_heads=2, num_frames=6, t_patch_size=3, pred_t_dim=6,
            attn_impl="naive")
        x3 = torch.ones((2, 6, 32, 32, 1), device=dev)  # 2 a data shard
        x2 = torch.ones((2, 3, 64, 64, 1), device=dev)
        tx = optim.build_adamw(model, sched, weight_decay=0.05)
        state = fsdp.shard_state(TrainState.create(model, tx, 2), mesh)
        step = mae_engine.make_mae_train_step(model, tx, joint=True,
                                              mesh=mesh)
        state, m = step(state, x3, 0.9, batch2d=x2, mask_ratio_2d=0.75)
        loss = m["loss"].item()
        _finite("the MAE step", m["loss"], *model.parameters())
        lines.append(f"dryrun_multichip({n}): mesh=({n_data}x{n_fsdp}) "
                     f"mae_loss={loss:.4f} step={state.step} OK")

        # 2. one 2-tower CLIP step, its loss over the global batch
        vcfg = dict(num_frames=6, t_patch_size=3, img_size=32, patch_size=16,
                    in_chans=1, embed_dim=32, depth=1, num_heads=2,
                    parity="standard")
        ecfg = dict(img_size=32, patch_size=16, in_chans=3, embed_dim=32,
                    depth=1, num_heads=2, parity="standard")
        clip = coem.create_model(coem.COEP2Tower, device=dev, seed=3,
                                 embed_dim=16, attn_impl="naive",
                                 vision_cfg=vcfg, enface_cfg=ecfg)
        ctx = optim.build_adamw(clip, schedules.warmup_half_cosine(
            1e-4, 0.0, 1, 10, 100), weight_decay=0.05)
        cstate = fsdp.shard_state(TrainState.create(clip, ctx, 4), mesh)
        cstep = clip_engine.make_clip_train_step(clip, ctx, mesh=mesh)
        cstate, cm = cstep(cstate, {
            "image": torch.ones((2, 6, 32, 32, 1), device=dev),
            "enface": torch.ones((2, 32, 32, 3), device=dev)})
        closs = cm["loss"].item()
        _finite("the CLIP step", cm["loss"], *clip.parameters())
        lines.append(f"dryrun_multichip({n}): clip_loss={closs:.4f} "
                     f"step={cstate.step} OK")

        # 3. dp x sp: the batch over data, a stack's tokens over sp
        n_sp = n // n_data
        sp_mesh = DeviceMesh(dev_type, torch.arange(n).reshape(n_data, n_sp),
                             mesh_dim_names=("data", "sp"))
        dim, n_tok = 32, 16 * n_sp + 1
        torch.manual_seed(5)
        stack = TransformerStack(2, dim, 2, parity="standard",
                                 attn_impl="flash_sp").to(dev)
        xs = torch.ones((2, n_tok, dim), device=dev)  # 2 a data shard
        with use_sequence_parallel(sp_mesh, "sp", batch_axis="data",
                                   shard_stacks=True):
            sl = (stack(xs).float() ** 2).mean()
            sgrads = torch.autograd.grad(sl, list(stack.parameters()))
        sloss = multihost.all_reduce_mean([sl.detach()])[0].item()
        _finite("the dp x sp stack", sl, *sgrads)
        lines.append(f"dryrun_multichip({n}): sp_loss={sloss:.4f} (batch "
                     f"{2 * n_data} x seq {n_tok} over composed "
                     f"{n_data}x{n_sp} dp x sp mesh) OK")

        # 4. ring attention on the same mesh, q / k / v over data and sp
        qkv = [(torch.ones((2, 2, 8, 16), device=dev) * s).requires_grad_()
               for s in (0.1, 0.2, 0.3)]
        rl = (ring_attention(*qkv, sp_mesh, "sp", batch_axis="data")
              .float() ** 2).mean()
        rgrads = torch.autograd.grad(rl, qkv)
        rloss = multihost.all_reduce_mean([rl.detach()])[0].item()
        _finite("ring attention", rl, *rgrads)
        lines.append(f"dryrun_multichip({n}): ring_loss={rloss:.4f} "
                     f"(ring backward over dp x sp) OK")

        # 5. tensor parallelism: n heads over an n-way tp axis
        tp_mesh = DeviceMesh(dev_type, torch.arange(n),
                             mesh_dim_names=("tp",))
        torch.manual_seed(6)
        tstack = TransformerStack(2, 16 * n, n, parity="standard",
                                  attn_impl="flash_tp").to(dev)
        shard_tp_params(tstack, tp_mesh)
        xt = torch.ones((2, 48, 16 * n), device=dev)
        with use_tensor_parallel(tp_mesh, "tp"):
            tl = (tstack(xt).float() ** 2).mean()
            tgrads = torch.autograd.grad(tl, list(tstack.parameters()))
        _finite("the tp stack", tl, *tgrads)
        lines.append(f"dryrun_multichip({n}): tp_loss={tl.item():.4f} "
                     f"({n} heads over {n}-way tp) OK")

        # the production geometry: ViT-L widths through the flash kernels
        # (their plain versions on the CPU), depth cut to 2 + 1
        t0 = time.time()
        prod = mae3d.create_model(
            mae3d.MaskedAutoencoderViT3D, device=dev, seed=7, input_size=256,
            high_res_input_size=512, patch_size=16, in_chans=1,
            embed_dim=1024, depth=2, num_heads=16, decoder_embed_dim=512,
            decoder_depth=1, decoder_num_heads=4, num_frames=60,
            t_patch_size=3, pred_t_dim=60, attn_impl="flash",
            dtype=torch.bfloat16)
        ptx = optim.build_adamw(prod, sched, weight_decay=0.05)
        pstate = fsdp.shard_state(TrainState.create(prod, ptx, 8), mesh)
        classes = sorted({_class_name(k) for k in pstate.shards.dims})
        if len(classes) < 3:
            raise AssertionError(f"fsdp_param_spec sharded only {classes}")
        pstep = mae_engine.make_mae_train_step(prod, ptx, joint=True,
                                               mesh=mesh)
        p3 = torch.ones((1, 60, 256, 256, 1), device=dev)  # 1 a data shard
        p2 = torch.ones((1, 3, 512, 512, 1), device=dev)
        pstate, pm = pstep(pstate, p3, 0.90, batch2d=p2, mask_ratio_2d=0.80)
        ploss = pm["loss"].item()
        _finite("the production-geometry step", pm["loss"], pm["grad_norm"])
        kernels = "B1 / B2" if dev_type == "cuda" else "their plain versions"
        lines.append(
            f"dryrun_multichip({n}): production-geometry joint step OK — "
            f"loss={ploss:.4f}, enc 513-vis / dec 5121 tokens + 512^2 2D "
            f"branch, flash ({kernels}), dp{n_data} x fsdp{n_fsdp} "
            f"({len(classes)} param classes fsdp-sharded: {classes[:6]}, by "
            f"{fsdp_param_spec.__name__}), {time.time() - t0:.0f}s")
        lines.append("dryrun_multichip: pp/ep n/a — largest model (ViT-L/H) "
                     "fits a single stage and the family has no MoE "
                     "experts; dp/fsdp/sp/tp covered above")
        if not all(math.isfinite(v) for v in (loss, closs, sloss, rloss,
                                              ploss)):
            raise AssertionError("a leg's loss is not finite")
        if rank == 0:
            with open(os.path.join(tmp, "lines.json"), "w") as f:
                json.dump(lines, f)
        multihost.barrier()
    finally:
        multihost.shutdown()
