"""Port parity: data- and sequence-parallel training steps on 4 gloo
ranks against the JAX package, and the sp4 pretraining preset's CLI.

Four CPU processes (spawn) form a gloo group through
``core/multihost.initialize`` with a ``FileStore``; each runs every case
once per module and writes numpy results.  JAX is imported in the test
process only.

- ``make_mae_train_step`` with ``mesh`` (data = 4): two steps, plain,
  ``accum_iter = 2`` and joint with ``accum_2d = 2``, each rank given its
  rows of the global batch and of JAX's noise, against JAX's step on a
  data = 4 mesh with ``shard_batch`` / ``shard_microbatch`` /
  ``replicate_state``; and without given noise (the rank's rows of one
  global draw) against the port's one-rank step on the global batch.
- The same step on a (data 1, fsdp 1, sp 4) mesh with the stacks
  sharding their tokens (``shard_stacks=True``) against JAX's step.
- ``make_finetune_train_step`` with ``mesh``: three steps under the
  multi-task criterion (which divides by the batch's valid count), the
  second with one rank's volume NaN: every rank reverts, as JAX's guard.
- ``cli/pretrain.py`` on the vitl_joint_pretrain_sp4 geometry at tiny
  size on 4 ranks against one rank on the same batch.

Tolerances: the steps' loss and grad norm 1e-5 relative and params 2e-6
after two Adam updates at eps 1e-5 (test_torch_port_train.py: Adam's
u = m / (sqrt(v) + eps) is steep where a gradient cancels to ~eps).  The
CLI runs the default eps 1e-8, where such an entry may flip sign: its
params are held to 2 x the summed LR (a flip) with at most 1e-3 of the
entries off by more than 1e-6, and its logged loss to 1e-5.
TensorBoard is stubbed in the CLI runs (test_torch_port_multihost.py's
``_no_tensorboard``: its import loads TensorFlow, ~20 s a process).
"""

import dataclasses
import datetime
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
JOIN_S = 300
EPS = 1e-5
TOL_METRIC = dict(rtol=1e-5, atol=1e-6)
TOL_PARAM = dict(rtol=1e-5, atol=2e-6)
# (name, joint, accum_iter, accum_2d)
DP_CASES = [("plain", False, 1, 1), ("accum_iter2", False, 2, 1),
            ("joint_accum_2d2", True, 1, 2)]
FT_STEPS = ((3, None), (4, 1), (5, None))  # (seed, the rank with a NaN)
CLI_LR = 1e-4


def _model_kw():
    return dict(patch_size=16, in_chans=1, embed_dim=128, depth=2,
                num_heads=2, decoder_embed_dim=128, decoder_depth=1,
                num_frames=24, t_patch_size=3, input_size=64,
                high_res_input_size=128, decoder_num_heads=4, pred_t_dim=24)


def _volume(b, frames=24, size=64, seed=5):
    return np.random.default_rng(seed).standard_normal(
        (b, frames, size, size, 1)).astype(np.float32)


def _ft_kw():
    return dict(num_frames=6, t_patch_size=3, img_size=32, patch_size=16,
                in_chans=1, num_classes=6, embed_dim=128, depth=2,
                num_heads=2, head_type="aggregate")


def _ft_batch(seed, nan_rank=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((WORLD, 6, 32, 32, 1)).astype(np.float32)
    if nan_rank is not None:
        x[nan_rank, 0, 0, 0, 0] = np.nan
    y = (rng.random((WORLD, 4)) > 0.5).astype(np.float32)
    y[:, 0] = (y[:, 1:].sum(1) == 0)
    return x, y


def _cli_config(tmp, sp: bool) -> str:
    """The vitl_joint_pretrain_sp4 preset cut for a CPU run (one epoch of
    two steps, no warmup, 2D batch 4 whole, fp32); the one-rank reference
    without sp and with blr x 4, as its eff_batch counts one rank."""
    from octcubem_tpu_torch.core.config import PRESETS

    cfg = dataclasses.asdict(PRESETS["vitl_joint_pretrain_sp4"])
    eff = 2 * WORLD  # batch 2 x accum 1 x world 4
    cfg.update(epochs=1, warmup_epochs=0, batch_size=2, batch_size_2d=4,
               accum_2d=1, min_lr=CLI_LR, blr=CLI_LR * 256 / eff,
               precision="fp32")
    if not sp:
        cfg.update(n_sp=1, attn_impl="auto", blr=CLI_LR * 256 / 2)
    path = Path(tmp) / ("sp4.json" if sp else "ref.json")
    path.write_text(json.dumps(cfg))
    return str(path)


def _cli_argv(cfg, out):
    return ["--preset", cfg, "--synthetic", "--tiny", "--synthetic_n", "8",
            "--steps_per_epoch", "2", "--device", "cpu", "--output_dir",
            str(out)]


# ------------------------------------------------------------- the ranks

def _mae_state(sd, kw):
    from octcubem_tpu_torch.models.mae3d import MaskedAutoencoderViT3D
    from octcubem_tpu_torch.train import optim
    from octcubem_tpu_torch.train.train_state import TrainState

    tm = MaskedAutoencoderViT3D(**kw)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                       strict=True)
    tx = optim.build_fused_adamw(tm, 1e-3, weight_decay=0.05, eps=EPS)
    return tm, tx, TrainState.create(tm, tx, seed=7)


def _rows(a, r, micro: bool):
    """Rank r's rows of a global batch (dim 1 for [accum, micro, ...])."""
    if a is None:
        return None
    n = a.shape[1 if micro else 0] // WORLD
    return a[:, r * n:(r + 1) * n] if micro else a[r * n:(r + 1) * n]


def _rank_main(rank, store_path, data, out_dir):
    from octcubem_tpu_torch.cli import pretrain
    from octcubem_tpu_torch.core import multihost
    from octcubem_tpu_torch.core.mesh import make_mesh
    from octcubem_tpu_torch.models.vit_st import VisionTransformerST
    from octcubem_tpu_torch.parallel.sequence import use_sequence_parallel
    from octcubem_tpu_torch.train import finetune_engine, losses, optim
    from octcubem_tpu_torch.train import mae_engine, schedules
    from octcubem_tpu_torch.train.train_state import TrainState
    from octcubem_tpu_torch.utils import profiling

    torch.set_num_threads(1)
    multihost.initialize(store=dist.FileStore(store_path, WORLD),
                         world_size=WORLD, rank=rank, device="cpu",
                         timeout_s=60)
    try:
        res = {}
        kw = _model_kw()
        dp = make_mesh(n_data=WORLD, device="cpu")
        for name, joint, accum_iter, accum_2d in DP_CASES:
            c = data[name]
            tm, tx, state = _mae_state(data["mae_sd"], kw)
            step = mae_engine.make_mae_train_step(
                tm, tx, joint=joint, accum_iter=accum_iter,
                accum_2d=accum_2d, mesh=dp)
            b3 = torch.from_numpy(_rows(c["b3"], rank, accum_iter > 1))
            b2 = (torch.from_numpy(_rows(c["b2"], rank, accum_iter > 1
                                         or accum_2d > 1)) if joint else None)
            for i in range(2):
                noise = [torch.from_numpy(_rows(n, rank, False))
                         for n in c["noise"][i]]
                state, m = step(state, mae_engine.shard_batch(b3, dp)
                                if accum_iter == 1 else
                                mae_engine.shard_microbatch(b3, dp), 0.9,
                                b2, 0.75, noise=noise)
                for k in ("loss", "loss_3d", "loss_2d", "grad_norm",
                          "frame_losses"):
                    res[f"{name}/{i}/{k}"] = m[k].numpy()
                res[f"{name}/{i}/phases"] = np.array(
                    sorted(profiling.RECORDS[-1]["phases"]))
            res.update({f"{name}/param/{k}": p.detach().numpy()
                        for k, p in tm.named_parameters()})

        # the generator's global draw: no noise given
        tm, tx, state = _mae_state(data["mae_sd"], kw)
        step = mae_engine.make_mae_train_step(tm, tx, mesh=dp)
        b3 = torch.from_numpy(_rows(data["plain"]["b3"], rank, False))
        for i in range(2):
            state, m = step(state, b3, 0.9)
            res[f"gen/{i}/loss"] = m["loss"].numpy()
        res.update({f"gen/param/{k}": p.detach().numpy()
                    for k, p in tm.named_parameters()})

        # sequence parallel over 4 ranks: every rank the whole batch
        sp = make_mesh(n_data=1, n_sp=WORLD, device="cpu")
        tm, tx, state = _mae_state(data["mae_sd"], dict(kw,
                                                        attn_impl="flash_sp"))
        step = mae_engine.make_mae_train_step(tm, tx, mesh=sp)
        c = data["sp"]
        for i in range(2):
            with use_sequence_parallel(sp, "sp", batch_axis="data",
                                       shard_stacks=True):
                state, m = step(state, torch.from_numpy(c["b3"]), 0.9,
                                noise=[torch.from_numpy(n)
                                       for n in c["noise"][i]])
            for k in ("loss", "grad_norm"):
                res[f"sp/{i}/{k}"] = m[k].numpy()
        res.update({f"sp/param/{k}": p.detach().numpy()
                    for k, p in tm.named_parameters()})

        # the fine-tune step, its NaN guard global
        fm = VisionTransformerST(**_ft_kw())
        fm.load_state_dict({k: torch.from_numpy(v)
                            for k, v in data["ft_sd"].items()}, strict=True)
        ftx = optim.AdamW(fm, schedules.warmup_half_cosine(1e-3, 0.0, 0, 1, 8),
                          0.05, eps=EPS, scales=optim.layer_decay_scales(
                              fm, 2, 0.65, "params."))
        fstate = TrainState.create(fm, ftx, 0)
        fstep = finetune_engine.make_finetune_train_step(
            fm, ftx, losses.make_criterion("multi_task_default"), mesh=dp)
        for i, (seed, nan_rank) in enumerate(FT_STEPS):
            x, y = _ft_batch(seed, nan_rank)
            fstate, m = fstep(fstate, torch.from_numpy(x[rank:rank + 1]),
                              torch.from_numpy(y[rank:rank + 1]))
            res[f"ft/{i}/loss"] = m["loss"].numpy()
            res[f"ft/{i}/phases"] = np.array(
                sorted(profiling.RECORDS[-1]["phases"]))
            res[f"ft/{i}/finite"] = m["finite"].numpy()
            res.update({f"ft/{i}/param/{k}": p.detach().numpy().copy()
                        for k, p in fm.named_parameters()})

        # the sp4 preset's CLI
        from test_torch_port_multihost import _no_tensorboard

        _no_tensorboard(pytest.MonkeyPatch())
        pretrain.main(_cli_argv(data["cli_cfg"], data["cli_out"]))
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        multihost.shutdown()


# ----------------------------------------------------- the test process

def _jax_setup():
    import jax
    import jax.numpy as jnp

    from octcubem_tpu.models import mae3d as jmae
    from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax

    kw = _model_kw()
    jm = jmae.MaskedAutoencoderViT3D(**kw, attn_impl="naive")
    params = jm.init({"params": jax.random.key(0),
                      "masking": jax.random.key(0)},
                     jnp.asarray(_volume(2)), mask_ratio=0.9)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    sd = {k: v.numpy() for k, v in state_dict_from_jax(params).items()}
    return jm, params, sd


def _jax_steps(jm, params, b3, b2, joint, accum_iter, accum_2d, mesh):
    """Two JAX steps (on ``mesh`` when given) -> (per-step metrics, the
    per-step noise in the port's order, the final params)."""
    import jax
    import jax.numpy as jnp

    from octcubem_tpu.train import mae_engine as jeng
    from octcubem_tpu.train import optim as jopt
    from octcubem_tpu.train.train_state import TrainState as JState
    from test_torch_port_train import _replay_noise

    tx = jopt.build_fused_adamw(params, 1e-3, weight_decay=0.05, eps=EPS)
    state = JState.create(params, tx, jax.random.key(2))
    step = jeng.make_mae_train_step(jm, tx, joint=joint,
                                    accum_iter=accum_iter, donate=False,
                                    accum_2d=accum_2d)
    x3, x2 = jnp.asarray(b3), jnp.asarray(b2) if joint else None
    if mesh is not None:
        state = jeng.replicate_state(state, mesh)
        x3 = (jeng.shard_microbatch(x3, mesh) if accum_iter > 1
              else jeng.shard_batch(x3, mesh))
        if joint:
            x2 = (jeng.shard_microbatch(x2, mesh) if accum_iter > 1
                  or accum_2d > 1 else jeng.shard_batch(x2, mesh))
    metrics, noises = [], []
    for _ in range(2):
        noise = _replay_noise(jm, jax.device_get(state.params), state.rng,
                              b3, b2, accum_iter, joint, accum_2d)
        noises.append([n.numpy() for n in noise])
        state, m = step(state, x3, mask_ratio=0.9, batch2d=x2,
                        mask_ratio_2d=0.75)
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return metrics, noises, jax.device_get(state.params)


def _ft_jax():
    import jax
    import jax.numpy as jnp
    import optax

    from octcubem_tpu.core.mesh import make_mesh as jmake_mesh
    from octcubem_tpu.models import vit_st as jvst
    from octcubem_tpu.train import finetune_engine as jfeng
    from octcubem_tpu.train import losses as jlosses
    from octcubem_tpu.train import mae_engine as jeng
    from octcubem_tpu.train import optim as joptim
    from octcubem_tpu.train import schedules as jsched
    from octcubem_tpu.train.train_state import TrainState as JState
    from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax

    jm = jvst.VisionTransformerST(**_ft_kw(), attn_impl="naive")
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 6, 32, 32, 1)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    tx = optax.chain(
        optax.scale_by_adam(b1=0.9, b2=0.95, eps=EPS),
        optax.add_decayed_weights(0.05, joptim.weight_decay_mask(params)),
        joptim.scale_by_tree(joptim.layer_decay_scales(params, 2, 0.65)),
        optax.scale_by_learning_rate(jsched.warmup_half_cosine(
            1e-3, 0.0, 0, 1, 8)))
    mesh = jmake_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    step = jfeng.make_finetune_train_step(
        jm, tx, jlosses.make_criterion("multi_task_default"))
    state = jeng.replicate_state(JState.create(params, tx,
                                               jax.random.key(2)), mesh)
    out = []
    for seed, nan_rank in FT_STEPS:
        x, y = _ft_batch(seed, nan_rank)
        state, m = step(state, jeng.shard_batch(jnp.asarray(x), mesh),
                        jnp.asarray(y))
        out.append((float(m["loss"]), bool(m["finite"]),
                    {k: v.numpy() for k, v in state_dict_from_jax(
                        jax.device_get(state.params)).items()}))
    sd = {k: v.numpy() for k, v in state_dict_from_jax(params).items()}
    return sd, out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """JAX's runs, then every case on 4 gloo ranks -> (JAX results, the
    port's results, the CLI's output dir, the config dir)."""
    import jax

    from octcubem_tpu.core.mesh import make_mesh as jmake_mesh

    tmp = tmp_path_factory.mktemp("gloo_dp")
    jm, params, mae_sd = _jax_setup()
    mesh = jmake_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    data = {"mae_sd": mae_sd}
    ref = {}
    for name, joint, accum_iter, accum_2d in DP_CASES:
        b3 = _volume(WORLD * accum_iter, seed=21)
        b2 = (_volume(WORLD * accum_2d, frames=3, size=128, seed=22)
              if joint else None)
        if accum_iter > 1:
            b3 = b3.reshape(accum_iter, WORLD, *b3.shape[1:])
        if accum_2d > 1:
            b2 = b2.reshape(accum_2d, WORLD, *b2.shape[1:])
        metrics, noises, final = _jax_steps(jm, params, b3, b2, joint,
                                            accum_iter, accum_2d, mesh)
        data[name] = {"b3": b3, "b2": b2, "noise": noises}
        ref[name] = (metrics, final)
    b3 = _volume(2, seed=23)
    metrics, noises, final = _jax_steps(jm, params, b3, None, False, 1, 1,
                                        None)
    data["sp"] = {"b3": b3, "noise": noises}
    ref["sp"] = (metrics, final)
    data["ft_sd"], ref["ft"] = _ft_jax()
    data["cli_cfg"] = _cli_config(tmp, sp=True)
    data["cli_out"] = str(tmp / "cli_sp4")

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp / "store"), data, str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=JOIN_S)
    for p in procs:
        p.join(max(1.0, (deadline - datetime.datetime.now()).total_seconds()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} did not finish within {JOIN_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * WORLD, f"rank exit codes {codes}"
    return ref, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)], \
        data, tmp


def _params_close(got: dict, want: dict, prefix: str, tol=TOL_PARAM):
    from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax

    want = {k: v.numpy() for k, v in state_dict_from_jax(want).items()} \
        if not isinstance(next(iter(want.values())), np.ndarray) else want
    names = {k[len(prefix):] for k in got if k.startswith(prefix)}
    assert names == set(want)
    for k in names:
        np.testing.assert_allclose(got[prefix + k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("case", [c[0] for c in DP_CASES])
def test_data_parallel_mae_steps_match_jax(ranks, case):
    """Per step: the loss, its parts and the grad norm equal JAX's global
    ones on every rank, the frame losses are the rank's rows of JAX's;
    the params after two steps equal JAX's on every rank."""
    ref, results, _, _ = ranks
    metrics, final = ref[case]
    for r, res in enumerate(results):
        for i in range(2):
            for k in ("loss", "loss_3d", "loss_2d", "grad_norm"):
                np.testing.assert_allclose(res[f"{case}/{i}/{k}"],
                                           metrics[i][k], **TOL_METRIC,
                                           err_msg=f"rank {r} step {i} {k}")
                assert res[f"{case}/{i}/{k}"] == results[0][f"{case}/{i}/{k}"]
            fl = metrics[i]["frame_losses"]
            n = fl.shape[0] // WORLD
            want = (fl[r * n:(r + 1) * n] if case != "accum_iter2" else
                    fl.reshape(2, WORLD, -1)[:, r].reshape(-1, fl.shape[-1]))
            np.testing.assert_allclose(res[f"{case}/{i}/frame_losses"], want,
                                       **TOL_METRIC)
        _params_close(res, final, f"{case}/param/")


def test_data_parallel_steps_record_the_reduce_phase(ranks):
    """A step over a reducing mesh records its gradient reduction as the
    ``reduce`` phase inside ``update``, beside forward, backward and
    AdamW's, on every rank (utils/profiling.py)."""
    _, results, _, _ = ranks
    want = ["adamw", "backward", "forward", "reduce", "update"]
    for res in results:
        for name, joint, *_ in DP_CASES:
            # a joint step's 2D forwards are a phase inside forward
            w = sorted(want + ["branch2d"]) if joint else want
            for i in range(2):
                assert res[f"{name}/{i}/phases"].tolist() == w
        for i in range(len(FT_STEPS)):
            assert res[f"ft/{i}/phases"].tolist() == want


def test_data_parallel_noise_is_the_global_draw(ranks):
    """Without given noise each rank masks with its rows of one global
    draw: four ranks equal the port's one-rank step on the global batch."""
    from octcubem_tpu_torch.train import mae_engine

    _, results, data, _ = ranks
    tm, tx, state = _mae_state(data["mae_sd"], _model_kw())
    step = mae_engine.make_mae_train_step(tm, tx)
    for i in range(2):
        state, m = step(state, torch.from_numpy(data["plain"]["b3"]), 0.9)
        for res in results:
            np.testing.assert_allclose(res[f"gen/{i}/loss"], m["loss"].numpy(),
                                       **TOL_METRIC)
    want = {k: p.detach().numpy() for k, p in tm.named_parameters()}
    for res in results:
        _params_close(res, want, "gen/param/")


def test_sequence_parallel_mae_step_matches_jax(ranks):
    """The MAE step with its stacks' tokens sharded over 4 sp ranks (the
    encoder's 13 tokens padded to 16, the decoder's 129 to 132): loss,
    grad norm and params after two steps against JAX's step."""
    ref, results, _, _ = ranks
    metrics, final = ref["sp"]
    for res in results:
        for i in range(2):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(res[f"sp/{i}/{k}"], metrics[i][k],
                                           **TOL_METRIC, err_msg=f"{i} {k}")
        _params_close(res, final, "sp/param/")


def test_data_parallel_finetune_step_reverts_together(ranks):
    """Three steps against JAX's on a data = 4 mesh; at the second, rank
    1's volume holds a NaN: the global loss is non-finite on every rank
    and every rank keeps its params, as JAX's guard keeps the state."""
    ref, results, _, _ = ranks
    for r, res in enumerate(results):
        for i, (jloss, jfinite, jparams) in enumerate(ref["ft"]):
            assert bool(res[f"ft/{i}/finite"]) == jfinite == (i != 1)
            if jfinite:
                np.testing.assert_allclose(res[f"ft/{i}/loss"], jloss,
                                           rtol=1e-5, atol=1e-6)
            _params_close(res, jparams, f"ft/{i}/param/")
        for k in (n for n in res if n.startswith("ft/1/param/")):
            np.testing.assert_array_equal(
                res[k], res[k.replace("ft/1/", "ft/0/")], err_msg=k)


def test_sp4_preset_cli_matches_one_rank(ranks, tmp_path, monkeypatch):
    """cli/pretrain.py on the sp4 preset at tiny size (n_sp = 4, every
    stack's tokens over 4 ranks) against the CLI on one rank without sp,
    on the same batches, at the same LR: the logged loss and the saved
    params (the module docstring's Adam rule)."""
    from octcubem_tpu_torch.cli import pretrain
    from octcubem_tpu_torch.core import checkpoint

    from test_torch_port_multihost import _no_tensorboard

    _, _, data, tmp = ranks
    out = tmp_path / "ref"
    _no_tensorboard(monkeypatch)
    pretrain.main(_cli_argv(_cli_config(tmp_path, sp=False), out))
    got_args = json.loads((Path(data["cli_out"]) / "args.json").read_text())
    assert got_args["n_sp"] == WORLD and got_args["attn_impl"] == "flash_sp"
    rec = [json.loads(x) for x in open(os.path.join(data["cli_out"],
                                                    "log.txt"))]
    want = [json.loads(x) for x in open(out / "log.txt")]
    np.testing.assert_allclose(rec[0]["train_loss"], want[0]["train_loss"],
                               rtol=1e-5)
    assert rec[0]["lr"] == pytest.approx(want[0]["lr"], rel=1e-12)
    got = checkpoint.restore_raw(os.path.join(data["cli_out"], "ckpt"))[0]
    ref = checkpoint.restore_raw(str(out / "ckpt"))[0]
    _assert_adam_close(got["params"], ref["params"], 2 * CLI_LR)


def _assert_adam_close(got: dict, want: dict, lr_sum: float):
    """Params after Adam steps at eps 1e-8: each entry within 2 x the
    summed LR (a sign flip where a gradient cancels to ~eps), and at most
    1e-3 of all entries off by more than 1e-6."""
    assert set(got) == set(want)
    off = total = 0
    for k in want:
        a, b = got[k].float().numpy(), want[k].float().numpy()
        d = np.abs(a - b)
        assert d.max() <= 2 * lr_sum + 1e-6, (k, d.max())
        off += int((d > 1e-6).sum())
        total += d.size
    assert off <= 1e-3 * total, (off, total)
