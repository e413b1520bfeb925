"""Port parity: training steps on a state sharded over fsdp
(``core/fsdp.shard_state``) against the JAX package's steps on a state
placed by ``put_tree(mesh, state, spec_fn)``, sharded checkpoints, and
``entry.dryrun_multichip`` on the CPU.

Four CPU processes (spawn, ``core/multihost.initialize`` with a
``FileStore``) form a (data 2 x fsdp 2) mesh; ranks of one data index
hold the same rows.  JAX runs on a 2 x 2 mesh of the conftest's virtual
CPU devices, its batch over ``data``.  Cases, two steps each:
``make_mae_train_step`` plain, with ``accum_iter = 2`` and joint with
``accum_2d = 2`` (the port's 2D branch through a remat ``model2d``), the
2-tower ``make_clip_train_step``, and ``make_finetune_train_step`` for
three steps, the second with a NaN in data index 1's volume, which every
rank reverts.  At these widths (128) no leaf reaches ``fsdp_param_spec``'s
2^20 elements, so those cases pass both packages the same policy at
2^13 (``_port_spec`` / ``_jax_spec``); the ``vitl`` case (embed 1024,
depth 1, decoder 512 x 1) runs ``fsdp_param_spec`` as it is.  Each rank's
chunks of params, ``mu`` and ``nu`` have the shard shape of JAX's array.

Two more ranks on a (data 1 x fsdp 2) mesh save a sharded state at
step 1 and resume it onto fsdp 2; this process resumes it onto one rank,
and the ranks resume a one-rank checkpoint onto fsdp 2; they also run
the CLIP feature-cached accumulation.  With one data index every rank's
gradient is one rank's (a sum of two equal fp32 values halves exactly),
so each next step, and each accumulation step, equals one rank's bit
for bit.  JAX is imported in the test process only.

Tolerances are test_torch_port_dp.py's: the loss and grad norm 1e-5
relative, params 2e-6 after two Adam updates at eps 1e-5.
"""

import contextlib
import datetime
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from test_torch_port_dp import (EPS, TOL_METRIC, _mae_state, _model_kw,
                                _params_close, _volume)

WORLD, N_DATA, N_FSDP = 4, 2, 2
CKPT_WORLD = 2
JOIN_S = 300
SMALL = 2 ** 13   # the lowered size threshold of the small cases
# (name, joint, accum_iter, accum_2d, policy)
MAE_CASES = [("plain", False, 1, 1, "small"),
             ("accum_iter2", False, 2, 1, "small"),
             ("joint_accum_2d2", True, 1, 2, "small"),
             ("vitl", False, 1, 1, "fsdp")]
FT_STEPS = ((3, None), (4, 1), (5, None))  # (seed, data index with a NaN)
VCFG = dict(num_frames=6, t_patch_size=3, img_size=32, patch_size=16,
            in_chans=1, embed_dim=64, depth=2, num_heads=2)
ECFG = dict(img_size=32, patch_size=16, in_chans=3, embed_dim=64, depth=2,
            num_heads=2)
# test_torch_port_clip_steps.py's Adam: at random init the towers' gradients
# sit near eps, where eps 1e-5 turns a 1e-9 difference into a step's
CLIP_LR, CLIP_WD, CLIP_EPS = 1e-3, 0.1, 1e-3


def _port_spec(name, t):
    """core/mesh.fsdp_param_spec's policy at SMALL elements."""
    from octcubem_tpu_torch.core.mesh import FSDP_AXIS, _flax_shape

    shape = tuple(t.shape)
    if len(shape) >= 2 and int(np.prod(shape)) >= SMALL:
        axis = int(np.argmax(_flax_shape(name, shape)))
        if len(shape) == 2 and name.endswith("weight"):
            axis = 1 - axis
        spec = [None] * len(shape)
        spec[axis] = FSDP_AXIS
        return tuple(spec)
    return ()


def _jax_spec(path, leaf):
    """octcubem_tpu/core/mesh.fsdp_param_spec's policy at SMALL elements."""
    from jax.sharding import PartitionSpec as P

    shape = np.shape(leaf)
    if len(shape) >= 2 and int(np.prod(shape)) >= SMALL:
        spec = [None] * len(shape)
        spec[int(np.argmax(shape))] = "fsdp"
        return P(*spec)
    return P()


def _mae_kw(case):
    kw = _model_kw()
    if case == "vitl":
        kw.update(embed_dim=1024, depth=1, num_heads=16,
                  decoder_embed_dim=512, decoder_depth=1,
                  decoder_num_heads=16)
    return kw


def _ft_kw():
    return dict(num_frames=6, t_patch_size=3, img_size=32, patch_size=16,
                in_chans=1, num_classes=6, embed_dim=128, depth=2,
                num_heads=2, head_type="aggregate")


def _ft_batch(seed, nan_row=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N_DATA, 6, 32, 32, 1)).astype(np.float32)
    if nan_row is not None:
        x[nan_row, 0, 0, 0, 0] = np.nan
    y = (rng.random((N_DATA, 4)) > 0.5).astype(np.float32)
    y[:, 0] = (y[:, 1:].sum(1) == 0)
    return x, y


def _clip_batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((2 * N_DATA, 6, 32, 32, 1), np.float32),
            "enface": rng.random((2 * N_DATA, 32, 32, 3), np.float32)}


def _rows(a, d, n_data=N_DATA, micro=False):
    """Data index d's rows of a global batch (dim 1 for [accum, micro])."""
    if a is None:
        return None
    n = a.shape[1 if micro else 0] // n_data
    return a[:, d * n:(d + 1) * n] if micro else a[d * n:(d + 1) * n]


# ------------------------------------------------------------- the ranks

def _shapes(prefix, state):
    """Each local chunk's shape: params, mu and nu by name."""
    out = {f"{prefix}/shape/param/{k}": np.array(p.shape)
           for k, p in state.params.named_parameters()}
    tx = state.tx
    for key in ("mu", "nu"):
        out.update({f"{prefix}/shape/{key}/{k}": np.array(t.shape)
                    for k, t in zip(tx.names, getattr(tx, key))})
    return out


def _whole_params(prefix, state):
    """The whole params (a gather over fsdp on every rank)."""
    sd = state.shards.host_state_dict(state, keep=True)
    return {f"{prefix}/param/{k}": v.numpy()
            for k, v in sd["params"].items()}


def _rank_main(rank, store_path, data, out_dir):
    from octcubem_tpu_torch.core import fsdp, multihost
    from octcubem_tpu_torch.core.mesh import fsdp_param_spec, make_mesh
    from octcubem_tpu_torch.models.vit_st import VisionTransformerST
    from octcubem_tpu_torch.train import (clip_engine, finetune_engine,
                                          losses, mae_engine, optim,
                                          schedules)
    from octcubem_tpu_torch.train.train_state import TrainState

    torch.set_num_threads(1)
    multihost.initialize(store=dist.FileStore(store_path, WORLD),
                         world_size=WORLD, rank=rank, device="cpu",
                         timeout_s=60)
    try:
        res = {}
        mesh = make_mesh(N_DATA, N_FSDP, device="cpu")
        d = rank // N_FSDP
        specs = {"small": _port_spec, "fsdp": fsdp_param_spec}
        for name, joint, accum_iter, accum_2d, policy in MAE_CASES:
            c = data[name]
            tm, tx, state = _mae_state(c["sd"], _mae_kw(name))
            fsdp.shard_state(state, mesh, specs[policy])
            res.update(_shapes(name, state))
            step = mae_engine.make_mae_train_step(
                tm, tx, joint=joint, accum_iter=accum_iter,
                accum_2d=accum_2d, mesh=mesh,
                model2d=tm.with_remat() if joint else None)
            b3 = torch.from_numpy(_rows(c["b3"], d, micro=accum_iter > 1))
            b2 = (torch.from_numpy(_rows(c["b2"], d, micro=accum_iter > 1
                                         or accum_2d > 1)) if joint else None)
            for i in range(2):
                noise = [torch.from_numpy(_rows(n, d)) for n in c["noise"][i]]
                state, m = step(state, b3, 0.9, b2, 0.75, noise=noise)
                for k in ("loss", "loss_3d", "loss_2d", "grad_norm"):
                    res[f"{name}/{i}/{k}"] = m[k].numpy()
            res.update(_whole_params(name, state))

        # the 2-tower CLIP step
        cm, ctx, cstate = _clip_state(data["clip_sd"])
        fsdp.shard_state(cstate, mesh, _port_spec)
        res.update(_shapes("clip", cstate))
        cstep = clip_engine.make_clip_train_step(cm, ctx, mesh=mesh)
        for i, seed in enumerate((3, 4)):
            batch = {k: torch.from_numpy(_rows(v, d))
                     for k, v in _clip_batch(seed).items()}
            cstate, m = cstep(cstate, batch)
            res[f"clip/{i}/loss"] = m["loss"].numpy()
            res[f"clip/{i}/grad_norm"] = m["grad_norm"].numpy()
        res.update(_whole_params("clip", cstate))

        # the fine-tune step, its NaN guard global
        fm = VisionTransformerST(**_ft_kw())
        fm.load_state_dict({k: torch.from_numpy(v)
                            for k, v in data["ft_sd"].items()}, strict=True)
        ftx = optim.AdamW(fm, schedules.warmup_half_cosine(1e-3, 0.0, 0, 1, 8),
                          0.05, eps=EPS, scales=optim.layer_decay_scales(
                              fm, 2, 0.65, "params."))
        fstate = fsdp.shard_state(TrainState.create(fm, ftx, 0), mesh,
                                  _port_spec)
        res.update(_shapes("ft", fstate))
        fstep = finetune_engine.make_finetune_train_step(
            fm, ftx, losses.make_criterion("multi_task_default"), mesh=mesh)
        for i, (seed, nan_row) in enumerate(FT_STEPS):
            x, y = _ft_batch(seed, nan_row)
            fstate, m = fstep(fstate, torch.from_numpy(x[d:d + 1]),
                              torch.from_numpy(y[d:d + 1]))
            res[f"ft/{i}/loss"] = m["loss"].numpy()
            res[f"ft/{i}/finite"] = m["finite"].numpy()
            res[f"ft/{i}/grad_norm"] = m["grad_norm"].numpy()
            res.update(_whole_params(f"ft/{i}", fstate))
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        multihost.shutdown()


def _clip_state(sd):
    """The 2-tower CLIP model from ``sd`` with its AdamW and state."""
    from octcubem_tpu_torch.models import coem
    from octcubem_tpu_torch.train import optim
    from octcubem_tpu_torch.train.train_state import TrainState

    cm = coem.create_model(coem.COEP2Tower, device="cpu", embed_dim=16,
                           vision_cfg=VCFG, enface_cfg=ECFG)
    cm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                       strict=True)
    ctx = optim.AdamW(cm, CLIP_LR, CLIP_WD, betas=(0.9, 0.98), eps=CLIP_EPS)
    return cm, ctx, TrainState.create(cm, ctx, 2)


def _accum_batch(seed):
    """_clip_batch as [accum 2, chunk 2, ...]."""
    return {k: torch.from_numpy(v.reshape(2, 2, *v.shape[1:]))
            for k, v in _clip_batch(seed).items()}


def _pair_rank(rank, store_path, data, out_dir):
    """The (data 1 x fsdp 2) ranks: an uninterrupted MAE run saving a
    checkpoint at step 1, a resume of it onto fsdp 2, a resume of the
    one-rank checkpoint onto fsdp 2, and two CLIP feature-cached
    accumulation steps."""
    from octcubem_tpu_torch.core import checkpoint, fsdp, multihost
    from octcubem_tpu_torch.core.mesh import make_mesh
    from octcubem_tpu_torch.train import clip_engine, mae_engine

    torch.set_num_threads(1)
    multihost.initialize(store=dist.FileStore(store_path, CKPT_WORLD),
                         world_size=CKPT_WORLD, rank=rank, device="cpu",
                         timeout_s=60)
    try:
        res = {}
        mesh = make_mesh(1, CKPT_WORLD, device="cpu")
        b3 = torch.from_numpy(data["b3"])

        def sharded():
            tm, tx, state = _mae_state(data["sd"], _model_kw())
            fsdp.shard_state(state, mesh, _port_spec)
            return state, mae_engine.make_mae_train_step(tm, tx, mesh=mesh)

        state, step = sharded()
        for i in range(2):
            state, m = step(state, b3, 0.9)
            res[f"run/{i}/loss"] = m["loss"].numpy()
            if i == 0:
                checkpoint.save_checkpoint(data["sharded_dir"], 1, state)
        res.update(_whole_params("run", state))
        for name, src in (("fsdp2", data["sharded_dir"]),
                          ("one_to_fsdp2", data["one_dir"])):
            state, step = sharded()
            checkpoint.restore_checkpoint(src, state)
            res[f"{name}/restored_step"] = np.asarray(state.step)
            state, m = step(state, b3, 0.9)
            res[f"{name}/loss"] = m["loss"].numpy()
            res.update(_whole_params(name, state))
        cm, ctx, cstate = _clip_state(data["clip_sd"])
        fsdp.shard_state(cstate, mesh, _port_spec)
        cstep = clip_engine.make_clip_accum_train_step(cm, ctx, 2, mesh=mesh)
        for i in range(2):
            cstate, m = cstep(cstate, _accum_batch(3 + i))
            res[f"accum/{i}/loss"] = m["loss"].numpy()
        res.update(_whole_params("accum", cstate))
        np.savez(Path(out_dir) / f"ckpt{rank}.npz", **res)
    finally:
        multihost.shutdown()


# ----------------------------------------------------- the test process

def _random_params(init, seed=1):
    """Seeded numpy params in the shapes of ``init(key)``'s tree: 0.05
    times a normal draw, plus 1 for a LayerNorm scale (no flax init is
    compiled: each costs seconds on the CPU)."""
    import jax

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.key(0))
    return jax.tree_util.tree_map_with_path(
        lambda path, s: (float(path[-1].key == "scale")
                         + 0.05 * rng.standard_normal(s.shape)
                         ).astype(np.float32), shapes)


def _jax_mae_setup(case):
    import jax.numpy as jnp

    from octcubem_tpu.models import mae3d as jmae
    from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax

    jm = jmae.MaskedAutoencoderViT3D(**_mae_kw(case), attn_impl="naive")
    params = _random_params(lambda key: jm.init(
        {"params": key, "masking": key}, jnp.asarray(_volume(2)),
        mask_ratio=0.9))
    sd = {k: v.numpy() for k, v in state_dict_from_jax(params).items()}
    return jm, params, sd


def _shard_shapes(tree):
    """The port-layout shape of each leaf's shard, by port name."""
    import jax

    from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax

    return {k: tuple(v.shape) for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(
            lambda a: np.zeros(a.sharding.shard_shape(a.shape), np.float32),
            tree)).items()}


def _adam_moments(opt_state):
    """(mu, nu) of an optax state (the ScaleByAdamState in the chain)."""
    import jax

    for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return s.mu, s.nu
    raise AssertionError("no Adam moments in the optimizer state")


def _jax_placed(state, mesh, spec):
    """put_tree(mesh, state, spec) -> (state, the shard shapes of params,
    mu and nu)."""
    from octcubem_tpu.core import multihost as jmh

    state = jmh.put_tree(mesh, state, spec)
    mu, nu = _adam_moments(state.opt_state)
    return state, {"param": _shard_shapes(state.params),
                   "mu": _shard_shapes(mu), "nu": _shard_shapes(nu)}


def _jax_mae(case, joint, accum_iter, accum_2d, policy, mesh, setup):
    """Both steps' inputs and noise -> (data for the ranks, a function
    running JAX's two steps on the placed state -> (metrics, final params,
    shard shapes)).  ``setup``: ``_jax_mae_setup(case)``."""
    import jax
    import jax.numpy as jnp

    from octcubem_tpu.core.mesh import fsdp_param_spec as jfsdp
    from octcubem_tpu.train import mae_engine as jeng
    from octcubem_tpu.train import optim as jopt
    from octcubem_tpu.train.train_state import TrainState as JState
    from test_torch_port_train import _replay_noise

    jm, params, sd = setup
    b3 = _volume(N_DATA * accum_iter, seed=21)
    b2 = (_volume(N_DATA * accum_2d, frames=3, size=128, seed=22)
          if joint else None)
    if accum_iter > 1:
        b3 = b3.reshape(accum_iter, N_DATA, *b3.shape[1:])
    if accum_2d > 1:
        b2 = b2.reshape(accum_2d, N_DATA, *b2.shape[1:])
    rngs = [jax.random.key(2)]
    rngs.append(jax.random.split(rngs[0])[1])
    noises = [[n.numpy() for n in _replay_noise(
        jm, params, r, b3, b2, accum_iter, joint, accum_2d)] for r in rngs]

    def run():
        tx = jopt.build_fused_adamw(params, 1e-3, weight_decay=0.05, eps=EPS)
        state, shapes = _jax_placed(
            JState.create(params, tx, jax.random.key(2)), mesh,
            _jax_spec if policy == "small" else jfsdp)
        step = jeng.make_mae_train_step(jm, tx, joint=joint,
                                        accum_iter=accum_iter, donate=False,
                                        accum_2d=accum_2d)
        micro = accum_iter > 1
        x3 = (jeng.shard_microbatch if micro else jeng.shard_batch)(
            jnp.asarray(b3), mesh)
        x2 = ((jeng.shard_microbatch if micro or accum_2d > 1
               else jeng.shard_batch)(jnp.asarray(b2), mesh)
              if joint else None)
        metrics = []
        for _ in range(2):
            state, m = step(state, x3, mask_ratio=0.9, batch2d=x2,
                            mask_ratio_2d=0.75)
            metrics.append({k: np.asarray(v) for k, v in m.items()})
        return metrics, jax.device_get(state.params), shapes

    return {"sd": sd, "b3": b3, "b2": b2, "noise": noises}, run


def _jax_clip(mesh):
    import jax
    import jax.numpy as jnp
    import optax

    from octcubem_tpu.models import coem as jcoem
    from octcubem_tpu.train import clip_engine as jeng
    from octcubem_tpu.train import mae_engine as jmae_eng
    from octcubem_tpu.train import optim as joptim
    from octcubem_tpu.train.train_state import TrainState as JState
    from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax

    jm = jcoem.COEP2Tower(embed_dim=16, vision_cfg=VCFG, enface_cfg=ECFG,
                          attn_impl="naive")
    b0 = _clip_batch(0)
    params = _random_params(lambda key: jm.init(key, b0["image"],
                                                 b0["enface"]))
    sd = {k: v.numpy() for k, v in state_dict_from_jax(params).items()}

    def run():
        tx = optax.chain(
            optax.scale_by_adam(b1=0.9, b2=0.98, eps=CLIP_EPS),
            optax.add_decayed_weights(CLIP_WD,
                                      joptim.weight_decay_mask(params)),
            optax.scale_by_learning_rate(CLIP_LR))
        state, shapes = _jax_placed(
            JState.create(params, tx, jax.random.key(2)), mesh, _jax_spec)
        step = jeng.make_clip_train_step(jm, tx)
        out = []
        for seed in (3, 4):
            batch = {k: jmae_eng.shard_batch(jnp.asarray(v), mesh)
                     for k, v in _clip_batch(seed).items()}
            state, m = step(state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out, jax.device_get(state.params), shapes

    return sd, run


def _jax_ft(mesh):
    import jax
    import jax.numpy as jnp
    import optax

    from octcubem_tpu.models import vit_st as jvst
    from octcubem_tpu.train import finetune_engine as jfeng
    from octcubem_tpu.train import losses as jlosses
    from octcubem_tpu.train import mae_engine as jeng
    from octcubem_tpu.train import optim as joptim
    from octcubem_tpu.train import schedules as jsched
    from octcubem_tpu.train.train_state import TrainState as JState
    from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax

    jm = jvst.VisionTransformerST(**_ft_kw(), attn_impl="naive")
    params = _random_params(lambda key: jm.init(
        key, jnp.zeros((1, 6, 32, 32, 1))))
    sd = {k: v.numpy() for k, v in state_dict_from_jax(params).items()}

    def run():
        tx = optax.chain(
            optax.scale_by_adam(b1=0.9, b2=0.95, eps=EPS),
            optax.add_decayed_weights(0.05, joptim.weight_decay_mask(params)),
            joptim.scale_by_tree(joptim.layer_decay_scales(params, 2, 0.65)),
            optax.scale_by_learning_rate(jsched.warmup_half_cosine(
                1e-3, 0.0, 0, 1, 8)))
        state, shapes = _jax_placed(
            JState.create(params, tx, jax.random.key(2)), mesh, _jax_spec)
        step = jfeng.make_finetune_train_step(
            jm, tx, jlosses.make_criterion("multi_task_default"))
        out = []
        for seed, nan_row in FT_STEPS:
            x, y = _ft_batch(seed, nan_row)
            state, m = step(state, jeng.shard_batch(jnp.asarray(x), mesh),
                            jnp.asarray(y))
            out.append((float(m["loss"]), bool(m["finite"]),
                        float(m["grad_norm"]),
                        {k: v.numpy() for k, v in state_dict_from_jax(
                            jax.device_get(state.params)).items()}))
        return out, shapes

    return sd, run


@contextlib.contextmanager
def _one_thread():
    """The ranks' thread count: the CPU kernels' reduction order, and so
    their bits, depends on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _one_rank_ckpt_run(sd, b3, ckpt_dir):
    """The uninterrupted one-rank run (saving at step 1) -> (losses, the
    params after steps 1 and 2)."""
    from octcubem_tpu_torch.core import checkpoint
    from octcubem_tpu_torch.train import mae_engine

    tm, tx, state = _mae_state(sd, _model_kw())
    step = mae_engine.make_mae_train_step(tm, tx)
    losses, params = [], []
    for i in range(2):
        state, m = step(state, torch.from_numpy(b3), 0.9)
        losses.append(m["loss"].numpy())
        params.append({k: p.detach().numpy().copy()
                       for k, p in tm.named_parameters()})
        if i == 0:
            checkpoint.save_checkpoint(ckpt_dir, 1, state)
    return losses, params


def _spawn(target, world, store, data, out_dir):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, store, data, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(procs, what):
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=JOIN_S)
    for p in procs:
        p.join(max(1.0, (deadline - datetime.datetime.now()).total_seconds()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"{what}: ranks {hung} did not finish within {JOIN_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * len(procs), f"{what}: rank exit codes {codes}"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' inputs, the ranks started, JAX's runs while they work,
    then their results -> (JAX results, the port's, the checkpoint ranks',
    the one-rank run, the checkpoint data)."""
    import jax

    from octcubem_tpu.core.mesh import make_mesh as jmake_mesh

    tmp = tmp_path_factory.mktemp("gloo_fsdp")
    mesh = jmake_mesh(n_data=N_DATA, n_fsdp=N_FSDP,
                      devices=jax.devices()[:WORLD])
    data, runs, setups = {}, {}, {}
    for case in MAE_CASES:
        kind = "vitl" if case[0] == "vitl" else "small"
        if kind not in setups:
            setups[kind] = _jax_mae_setup(case[0])
        data[case[0]], runs[case[0]] = _jax_mae(*case, mesh, setups[kind])
    data["clip_sd"], runs["clip"] = _jax_clip(mesh)
    data["ft_sd"], runs["ft"] = _jax_ft(mesh)
    ck = {"sd": data["plain"]["sd"], "b3": _volume(2, seed=23),
          "clip_sd": data["clip_sd"],
          "sharded_dir": str(tmp / "ckpt_sharded"),
          "one_dir": str(tmp / "ckpt_one")}
    with _one_thread():
        one = _one_rank_ckpt_run(ck["sd"], ck["b3"], ck["one_dir"])

    procs = _spawn(_rank_main, WORLD, str(tmp / "store"), data, str(tmp))
    ck_procs = _spawn(_pair_rank, CKPT_WORLD, str(tmp / "ckpt_store"), ck,
                      str(tmp))
    try:  # the steps' compiles overlap
        with ThreadPoolExecutor(max_workers=3) as pool:
            futures = {name: pool.submit(run) for name, run in runs.items()}
        ref = {name: fut.result() for name, fut in futures.items()}
    finally:
        _join(procs, "the fsdp ranks")
        _join(ck_procs, "the checkpoint ranks")
    results = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    ck_results = [dict(np.load(tmp / f"ckpt{r}.npz"))
                  for r in range(CKPT_WORLD)]
    return ref, results, ck_results, one, ck


def _assert_shard_shapes(res, prefix, shapes, whole=None):
    """Each local chunk's shape is JAX's shard shape, and some param is
    sharded -> the number of sharded params (``whole``: the prefix of the
    whole params, ``prefix`` by default)."""
    got = {key: {k.split("/", 3)[3]: tuple(v) for k, v in res.items()
                 if k.startswith(f"{prefix}/shape/{key}/")}
           for key in ("param", "mu", "nu")}
    for key in got:
        assert got[key] == shapes[key], (prefix, key)
    n = sum(s != res[f"{whole or prefix}/param/{k}"].shape
            for k, s in got["param"].items())
    assert n > 0, f"{prefix}: nothing sharded"
    return n


@pytest.mark.parametrize("case", [c[0] for c in MAE_CASES])
def test_fsdp_mae_steps_match_jax(ranks, case):
    """Per step the loss, its parts and the grad norm equal JAX's global
    ones on every rank; after two steps the whole params equal JAX's; each
    rank's chunks of params, mu and nu have JAX's shard shapes."""
    ref, results, _, _, _ = ranks
    metrics, final, shapes = ref[case]
    for r, res in enumerate(results):
        for i in range(2):
            for k in ("loss", "loss_3d", "loss_2d", "grad_norm"):
                np.testing.assert_allclose(res[f"{case}/{i}/{k}"],
                                           metrics[i][k], **TOL_METRIC,
                                           err_msg=f"rank {r} step {i} {k}")
                assert res[f"{case}/{i}/{k}"] == results[0][f"{case}/{i}/{k}"]
        _params_close(res, final, f"{case}/param/")
        n = _assert_shard_shapes(res, case, shapes)
        if case == "vitl":  # fsdp_param_spec as it is: the 2^20 leaves
            assert n == 6, n


def test_fsdp_clip_step_matches_jax(ranks):
    """The 2-tower CLIP step: loss and grad norm per step, the params after
    two steps, the chunks' shard shapes; logit_scale stays whole."""
    ref, results, _, _, _ = ranks
    steps, final, shapes = ref["clip"]
    for res in results:
        for i, (loss, gn) in enumerate(steps):
            np.testing.assert_allclose(res[f"clip/{i}/loss"], loss,
                                       **TOL_METRIC)
            np.testing.assert_allclose(res[f"clip/{i}/grad_norm"], gn,
                                       **TOL_METRIC)
        _params_close(res, final, "clip/param/")
        _assert_shard_shapes(res, "clip", shapes)
        assert res["clip/shape/param/logit_scale"].size == 0


def test_fsdp_finetune_step_reverts_together(ranks):
    """Three fine-tune steps against JAX's; at the second, data index 1's
    volume holds a NaN: every rank sees the global loss non-finite and
    keeps its chunks, as JAX's guard keeps the state."""
    ref, results, _, _, _ = ranks
    steps, shapes = ref["ft"]
    for r, res in enumerate(results):
        for i, (loss, finite, gn, params) in enumerate(steps):
            assert bool(res[f"ft/{i}/finite"]) == finite == (i != 1)
            if finite:
                np.testing.assert_allclose(res[f"ft/{i}/loss"], loss,
                                           **TOL_METRIC)
                np.testing.assert_allclose(res[f"ft/{i}/grad_norm"], gn,
                                           **TOL_METRIC)
            _params_close(res, params, f"ft/{i}/param/")
        for k in (n for n in res if n.startswith("ft/1/param/")):
            np.testing.assert_array_equal(
                res[k], res[k.replace("ft/1/", "ft/0/")], err_msg=k)
        _assert_shard_shapes(res, "ft", shapes, whole="ft/2")


def test_sharded_checkpoint_resumes_bit_exact(ranks, tmp_path):
    """A sharded state saved at step 1 holds the whole tensors of the
    one-rank run's; resumed onto fsdp 2 and onto one rank, and a one-rank
    checkpoint resumed onto fsdp 2, the next step equals the
    uninterrupted one-rank run's bit for bit, as does the uninterrupted
    sharded run."""
    from octcubem_tpu_torch.core import checkpoint
    from octcubem_tpu_torch.train import mae_engine

    _, _, ck_results, (losses, params), ck = ranks
    saved = checkpoint.restore_raw(ck["sharded_dir"], 1)[0]["params"]
    assert set(saved) == set(params[0])
    for k, v in params[0].items():
        np.testing.assert_array_equal(saved[k].numpy(), v, err_msg=k)
    tm, tx, state = _mae_state(ck["sd"], _model_kw())
    checkpoint.restore_checkpoint(ck["sharded_dir"], state)
    assert state.step == 1
    step = mae_engine.make_mae_train_step(tm, tx)
    with _one_thread():
        _, m = step(state, torch.from_numpy(ck["b3"]), 0.9)
    np.testing.assert_array_equal(m["loss"].numpy(), losses[1])
    for k, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), params[1][k],
                                      err_msg=f"one rank {k}")
    for res in ck_results:
        for i in range(2):
            np.testing.assert_array_equal(res[f"run/{i}/loss"], losses[i])
        for name in ("run", "fsdp2", "one_to_fsdp2"):
            if name != "run":
                assert res[f"{name}/restored_step"] == 1
                np.testing.assert_array_equal(res[f"{name}/loss"], losses[1])
            for k, v in params[1].items():
                np.testing.assert_array_equal(res[f"{name}/param/{k}"], v,
                                              err_msg=f"{name} {k}")


def test_fsdp_clip_accumulation_equals_one_rank(ranks):
    """Two feature-cached accumulation steps (accum_freq 2) on a (data 1
    x fsdp 2) sharded state equal one rank's bit for bit: each chunk's
    backward reduce-scatters into the chunk params' .grad."""
    from octcubem_tpu_torch.train import clip_engine

    _, _, ck_results, _, ck = ranks
    cm, ctx, cstate = _clip_state(ck["clip_sd"])
    step = clip_engine.make_clip_accum_train_step(cm, ctx, 2)
    losses = []
    with _one_thread():
        for i in range(2):
            cstate, m = step(cstate, _accum_batch(3 + i))
            losses.append(m["loss"].numpy())
    for res in ck_results:
        for i in range(2):
            np.testing.assert_array_equal(res[f"accum/{i}/loss"], losses[i])
        for k, v in cm.state_dict().items():
            np.testing.assert_array_equal(res[f"accum/param/{k}"],
                                          v.numpy(), err_msg=k)


def test_dryrun_multichip_on_cpu(capsys):
    """entry.dryrun_multichip(4, device="cpu"): four gloo ranks, JAX's
    five legs and the production-geometry step, each line printed."""
    from octcubem_tpu_torch import entry

    lines = entry.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert all(line in out for line in lines)
    assert lines[0] == "dryrun_multichip(4): 4 CPU processes, backend gloo"
    legs = ["mesh=(2x2) mae_loss=", "clip_loss=", "sp_loss=", "ring_loss=",
            "tp_loss=", "production-geometry joint step OK"]
    for want, line in zip(legs, lines[1:7]):
        assert want in line and "OK" in line, line
    assert "dp2 x fsdp2" in lines[6] and "Wqkv" in lines[6]
    assert len(lines) == 8
