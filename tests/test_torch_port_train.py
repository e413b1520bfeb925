"""Port parity: the MAE training path against the JAX package.

Schedules, the weight-decay mask and layer-decay scales (by parameter
name), both AdamW builds against optax over three updates, and two
consecutive ``make_mae_train_step`` steps against the JAX step from the
same params, batch and noise, at geometry (a) of test_torch_port_mae.py
(64x64 x 24 frames, mask 0.90: encoder 13 tokens, no cls fold; decoder
129, cls fold).  The JAX noise is replayed from its state's rng exactly
as its step splits it.  A constant LR of 1e-3 makes the first update
move the params.  fp32 tolerances, each stated where it is used.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from octcubem_tpu.models import mae3d as jmae
from octcubem_tpu.train import mae_engine as jeng
from octcubem_tpu.train import optim as jopt
from octcubem_tpu.train import schedules as jsched
from octcubem_tpu.train.train_state import TrainState as JState
from octcubem_tpu_torch.compat.jax_params import (_to_torch_key,
                                                  state_dict_from_jax)
from octcubem_tpu_torch.models import mae3d as tmae
from octcubem_tpu_torch.train import mae_engine as teng
from octcubem_tpu_torch.train import optim as topt
from octcubem_tpu_torch.train import schedules as tsched
from octcubem_tpu_torch.train.train_state import TrainState as TState

from test_torch_port_mae import jax_init, jax_noise, model_kw, torch_model, volume

# ------------------------------------------------------------ schedules


def test_lr_schedules_match_jax():
    """The JAX schedules compute in fp32, the port's in Python floats:
    1e-5 relative (fp32 cos of a large argument, step 25000)."""
    pairs = [(jsched.warmup_half_cosine(1.6e-3, 1e-5, 1, 50, 1000),
              tsched.warmup_half_cosine(1.6e-3, 1e-5, 1, 50, 1000)),
             (jsched.clip_cosine_lr(5e-4, 100, 2000),
              tsched.clip_cosine_lr(5e-4, 100, 2000))]
    for j, t in pairs:
        for step in (0, 1, 7, 99, 100, 500, 999, 1000, 1999, 25000):
            np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-5,
                                       atol=1e-12, err_msg=str(step))
    assert tsched.warmup_half_cosine(1.6e-3, 0.0, 1, 50, 1000)(0) == 0.0


def test_epoch_schedules_match_jax():
    for e in (0, 5, 10, 10.5, 37, 99):
        assert tsched.spl_k_schedule(e) == jsched.spl_k_schedule(e)
        assert (tsched.mask_ratio_2d_schedule(e, total_epochs=60)
                == jsched.mask_ratio_2d_schedule(e, total_epochs=60))
    assert tsched.scale_base_lr(1.5e-4, 512) == jsched.scale_base_lr(1.5e-4, 512)


# ------------------------------------------------- masks, by param name

def _by_port_name(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_to_torch_key(tuple(k.key for k in path))[0]: v
            for path, v in leaves}


def test_weight_decay_mask_and_layer_decay_match_jax():
    kw = model_kw("a")
    _, params = jax_init(kw, volume("a"), 0.9)
    tree = params["params"]
    tm = tmae.MaskedAutoencoderViT3D(**kw)
    mask = topt.weight_decay_mask(tm)
    assert mask == {k: bool(v) for k, v in
                    _by_port_name(jopt.weight_decay_mask(tree)).items()}
    assert not mask["pos_embed_spatial"] and not mask["mask_token"]
    assert mask["blocks.0.mixer.Wqkv.weight"] and mask["patch_embed.proj.weight"]
    scales = topt.layer_decay_scales(tm, num_blocks=2, layer_decay=0.75)
    ref = _by_port_name(jopt.layer_decay_scales(tree, 2, 0.75))
    assert scales.keys() == ref.keys()
    for k in scales:
        assert scales[k] == pytest.approx(ref[k], rel=1e-12), k
    assert scales["blocks.1.mlp.fc1.weight"] == pytest.approx(0.75)


# ------------------------------------------------------------- AdamW

# (JAX path, port name, shape); "blocks.1.fc.weight" never gets a gradient
LEAVES = [(("patch_embed", "kernel"), "patch_embed.proj.weight", (6, 5)),
          (("pos_embed",), "pos_embed", (1, 4, 6)),
          (("blocks", "blocks_0", "fc", "kernel"), "blocks.0.fc.weight", (6, 6)),
          (("blocks", "blocks_0", "fc", "bias"), "blocks.0.fc.bias", (6,)),
          (("blocks", "blocks_1", "fc", "kernel"), "blocks.1.fc.weight", (6, 6)),
          (("head", "kernel"), "head.weight", (6, 3))]
NO_GRAD = "blocks.1.fc.weight"


def _nest(flat):
    tree = {}
    for path, val in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = val
    return tree


@pytest.mark.parametrize("restored", [False, True])
@pytest.mark.parametrize("chain,mu_bf16", [(False, False), (True, False),
                                           (False, True)])
def test_adamw_matches_optax(chain, mu_bf16, restored):
    """Three updates with a decaying LR: fused (no clip, no layer decay)
    against build_fused_adamw, with mu stored in fp32 or bf16, and the
    chain (clip 1.0, layer decay 0.75) against optax's chain; the second
    update's gradients are small, so the clip holds on updates 1 and 3.  A leaf with no
    gradient: zeros in JAX, None in the port; both still decay it.
    ``restored``: between updates 1 and 2 the port's state is reloaded
    from a ``state_dict`` whose count is an ``int``, as checkpoints
    written before the count was a tensor hold it; the count stays one
    tensor.  Tolerance: the JAX fused-vs-chain test's own (1e-6
    relative)."""
    rng = np.random.default_rng(0)
    vals = {name: rng.standard_normal(shape).astype(np.float32)
            for _, name, shape in LEAVES}
    jparams = _nest({path: jnp.asarray(vals[name]) for path, name, _ in LEAVES})
    tparams = {name: torch.nn.Parameter(torch.from_numpy(vals[name].copy()))
               for name in vals}
    def sched(step):
        return 1e-2 / (1 + 0.1 * step)

    sched.total_steps = 5  # the device LR table: steps 0 .. 5
    if chain:
        tx_j = jopt.build_adamw(jparams, sched, 0.05, layer_decay=0.75,
                                num_blocks=2, clip_grad=1.0)
        tx_t = topt.build_adamw(tparams, sched, 0.05, layer_decay=0.75,
                                num_blocks=2, clip_grad=1.0)
    else:
        tx_j = jopt.build_fused_adamw(
            jparams, sched, 0.05, mu_dtype=jnp.bfloat16 if mu_bf16 else None)
        tx_t = topt.build_fused_adamw(
            tparams, sched, 0.05, mu_dtype=torch.bfloat16 if mu_bf16 else None)
    s_j = tx_j.init(jparams)
    count = tx_t.count
    for i, gscale in enumerate((3.0, 0.01, 3.0)):
        g = {name: gscale * np.random.default_rng(10 + i).standard_normal(
            v.shape).astype(np.float32) for name, v in vals.items()}
        g[NO_GRAD] = np.zeros_like(g[NO_GRAD])
        u, s_j = tx_j.update(
            _nest({path: jnp.asarray(g[name]) for path, name, _ in LEAVES}),
            s_j, jparams)
        jparams = optax.apply_updates(jparams, u)
        tx_t.zero_grad()
        for name, p in tparams.items():
            if name != NO_GRAD:
                p.grad = torch.from_numpy(g[name])
        tx_t.step()
        if restored and i == 0:
            saved = tx_t.state_dict()
            saved = {"count": int(saved["count"]),
                     **{k: {n: t.clone() for n, t in saved[k].items()}
                        for k in ("mu", "nu")}}
            count.fill_(7)
            for t in tx_t.mu + tx_t.nu:
                t.zero_()
            tx_t.load_state_dict(saved)
        ref = {name: np.asarray(v) for name, v in _by_port_name(jparams).items()}
        for name, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), ref[name],
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"update {i + 1} {name}")
    assert not np.allclose(tparams[NO_GRAD].detach().numpy(), vals[NO_GRAD])
    assert tx_t.count is count and int(count) == 3
    if mu_bf16:
        assert tx_t.mu[0].dtype == torch.bfloat16
        mu_ref = _by_port_name(s_j.mu)
        for name, mu in zip(tx_t.names, tx_t.mu):
            np.testing.assert_array_equal(mu.float().numpy(),
                                          np.asarray(mu_ref[name], np.float32))


# ------------------------------- the AdamW kernel's launches (csrc/adamw.cu)

class _AdamwLib:
    """Stands in for the kernel's library: records what each
    ``octcube_adamw`` call is handed (its host arrays read back)."""

    def __init__(self):
        self.calls = []

    def octcube_adamw(self, ptrs, sizes, ends, scale, decay, count, mu_bf16,
                      hyper, lr, c1, c2, clip, ok, stream):
        import ctypes

        def read(addr, ctype, n):
            return list((ctype * n).from_address(addr))

        self.calls.append({
            "ptrs": read(ptrs, ctypes.c_longlong, 4 * count),
            "sizes": read(sizes, ctypes.c_longlong, count),
            "ends": read(ends, ctypes.c_int, count),
            "scale": read(scale, ctypes.c_float, count),
            "decay": read(decay, ctypes.c_float, count),
            "mu_bf16": mu_bf16, "hyper": read(hyper, ctypes.c_float, 5),
            "dev": (lr, c1, c2, clip, ok)})
        return 0


def _walk(call, grid):
    """The kernel's blocks over one launch (csrc/adamw.cu's chunk loop),
    for ``grid`` blocks -> per tensor of the launch, how often each
    element is written."""
    ends = call["ends"]
    seen = [np.zeros(n, np.int64) for n in call["sizes"]]
    for b in range(grid):
        t, first = -1, 0
        for c in range(b, ends[-1], grid):
            if t < 0 or c >= ends[t]:
                t += 1
                while c >= ends[t]:
                    t += 1
                first = ends[t - 1] if t else 0
            e0 = (c - first) * topt.ADAMW_CHUNK
            seen[t][e0:e0 + topt.ADAMW_CHUNK] += 1
    return seen


# (2-D shapes decay, 1-D ones do not); sizes off a multiple of 4, empty
# tensors, and more tensors than one launch holds
ADAMW_SHAPES = {
    "ragged": [(5,), (3, 1), (2049,), (4099, 1), (1,), (6151,), (2048, 2)],
    "empty": [(0,), (6, 1), (0, 4), (10,), (0,)],
    "many": [(7,)] * 70 + [(3000, 2)] * 3 + [(1, 1)] + [(2,)] * 60,
}


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("shapes", list(ADAMW_SHAPES))
def test_adamw_kernel_launches_cover_each_element_once(monkeypatch, shapes,
                                                       gated):
    """``AdamW._kernel_update``'s launches (the library and the stream
    stood in for): every element of every non-empty tensor written once
    by the kernel's chunk walk at any grid, each launch at most
    ADAMW_GROUP tensors, and each tensor handed its own pointers, layer
    scale and decay rate wd s (0 where no decay applies); the LR and
    corrections by pointer, and with ``gated`` the clip factor and ok
    too (bf16 mu); a missing gradient as 0; a moment that moved, at its
    new address."""
    from types import SimpleNamespace

    rng = np.random.default_rng(3)
    shp = ADAMW_SHAPES[shapes]
    params = {f"blocks.{i}.w": torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))) for i, s in enumerate(shp)}
    scales = {n: 0.5 + 0.01 * i for i, n in enumerate(params)}
    tx = topt.AdamW(params, 1e-3, 0.05, clip_grad=1.0 if gated else None,
                    scales=scales,
                    mu_dtype=torch.bfloat16 if gated else None)
    for i, p in enumerate(params.values()):
        if i != 1:
            p.grad = torch.ones_like(p)
    lib = _AdamwLib()
    monkeypatch.setattr(topt._cuda, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    lr, c1, c2 = (torch.tensor(v) for v in (2e-3, 0.1, 0.05))
    ok = torch.tensor(True) if gated else None
    before = topt._cuda.launches["adamw"]
    tx._kernel_update(lr, c1, c2, ok)
    assert topt._cuda.launches["adamw"] == before + 1
    slot = {p.data_ptr(): i for i, p in enumerate(tx.params)}
    decayed = set(tx.decayed)
    covered = {}
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    for call in lib.calls:
        assert 1 <= len(call["sizes"]) <= topt.ADAMW_GROUP
        chunks = [-(-n // topt.ADAMW_CHUNK) for n in call["sizes"]]
        assert call["ends"] == list(np.cumsum(chunks))
        assert call["mu_bf16"] == int(gated)
        assert call["hyper"][:5] == [f32(v) for v in (0.9, 0.1, 0.95, 0.05,
                                                      1e-8)]
        for grid in (1, 7, call["ends"][-1] + 5):
            assert all((s == 1).all() for s in _walk(call, grid))
        for k, n in enumerate(call["sizes"]):
            i = slot[call["ptrs"][4 * k]]
            p, s = tx.params[i], scales[tx.names[i]]
            assert i not in covered and n == p.numel() > 0
            covered[i] = True
            assert call["ptrs"][4 * k:4 * k + 4] == [
                p.data_ptr(), 0 if p.grad is None else p.grad.data_ptr(),
                tx.mu[i].data_ptr(), tx.nu[i].data_ptr()]
            assert call["scale"][k] == f32(s)
            assert call["decay"][k] == f32(0.05 * s if i in decayed else 0.0)
        assert call["dev"][:3] == (lr.data_ptr(), c1.data_ptr(),
                                   c2.data_ptr())
        if gated:
            assert call["dev"][3] is not None and call["dev"][4] == ok.data_ptr()
        else:
            assert call["dev"][3:] == (None, None)
    assert sorted(covered) == [i for i, p in enumerate(tx.params)
                               if p.numel()]
    assert decayed & set(covered) and set(covered) - decayed
    # a moment that moved (fsdp places chunks so) is launched where it is
    last = max(covered)
    tx.nu[last] = tx.nu[last].clone()
    lib.calls.clear()
    tx._kernel_update(lr, c1, c2, ok)
    assert tx.nu[last].data_ptr() in lib.calls[-1]["ptrs"]


def test_adamw_kernel_refuses_what_it_does_not_take(monkeypatch):
    """The kernel's wrapper raises, before any launch, on a param (and
    its gradient) off fp32, mu off fp32 and bf16, and an ok that is no
    bool."""
    lib = _AdamwLib()
    monkeypatch.setattr(topt._cuda, "library", lambda name: lib)

    def tx_with(dtype=torch.float32, mu=None):
        p = torch.nn.Parameter(torch.ones((4, 3), dtype=dtype))
        p.grad = torch.ones_like(p)
        return topt.AdamW({"w": p}, 1e-3, mu_dtype=mu)

    lr, c1, c2 = (torch.tensor(v) for v in (1e-3, 0.1, 0.05))
    for tx in (tx_with(torch.float64), tx_with(mu=torch.float16)):
        with pytest.raises(ValueError, match="AdamW kernel"):
            tx._kernel_update(lr, c1, c2, None)
    with pytest.raises(ValueError, match="ok"):
        tx_with()._kernel_update(lr, c1, c2, torch.tensor(1.0))
    assert lib.calls == []


def test_adamw_cpu_path_is_the_foreach_body(monkeypatch):
    """A CPU param list takes the multi-tensor body, gated or not: its
    ops in a profile, the kernel's library never asked for, no launch
    counted."""
    from torch.profiler import ProfilerActivity, profile

    def refuse(name):
        raise AssertionError(f"library {name} asked for on the CPU")

    monkeypatch.setattr(topt._cuda, "library", refuse)
    lin = torch.nn.Linear(8, 4)
    tx = topt.AdamW(lin, tsched.warmup_half_cosine(1e-2, 1e-4, 1, 3, 4),
                    0.05, clip_grad=1.0)
    before = dict(topt._cuda.launches)
    for ok in (None, torch.tensor(True)):
        for p in lin.parameters():
            p.grad = torch.ones_like(p)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tx.step(ok=ok)
        names = {e.name for e in prof.events()}
        assert {"aten::_foreach_addcmul_", "aten::_foreach_div_",
                "aten::_foreach_sqrt_"} <= names
    assert topt._cuda.launches == before


# ----------------------------------------------------- the train step

# loss and grad norm: the JAX package's full-model fp32 tolerance
# (tests/test_torch_parity.py).  Params after an update, p - lr * u with
# u = m / (sqrt(v) + eps): a gradient difference dg moves u by up to
# dg / eps, and entries whose gradient cancels to ~0 (in the patch embed
# and pos_embed_spatial) differ by dg ~ 5e-9 between the two packages'
# fp32 sums.  At the default eps = 1e-8 that flips u's sign there, so
# these steps run eps = 1e-5 (du <= 5e-4, dp <= lr * du = 5e-7, held at
# 2e-6; measured at most 9.4e-7); the default eps is held to optax in
# test_adamw_matches_optax.
EPS = 1e-5
TOL_METRIC = dict(rtol=1e-5, atol=1e-6)
TOL_PARAM = dict(rtol=1e-5, atol=2e-6)


def _replay_noise(jm, params, rng, b3, b2, accum_iter, joint, accum_2d=1):
    """JAX's masking noise for one step, from the state's rng as its step
    splits it, in the order the port's step draws it."""
    rng, _ = jax.random.split(rng)
    if accum_2d > 1:  # accum2d_step: the 3D batch, then each 2D microbatch
        r3, r2 = jax.random.split(rng)
        return [torch.from_numpy(jax_noise(jm, params, x, key)) for x, key in
                [(b3, r3)] + list(zip(b2, jax.random.split(r2, accum_2d)))]
    keys = [rng] if accum_iter == 1 else list(jax.random.split(rng, accum_iter))
    noise = []
    for i, key in enumerate(keys):
        r3, r2 = jax.random.split(key)
        x3 = b3 if accum_iter == 1 else b3[i]
        noise.append(torch.from_numpy(jax_noise(jm, params, x3, r3)))
        if joint:
            x2 = b2 if accum_iter == 1 else b2[i]
            noise.append(torch.from_numpy(jax_noise(jm, params, x2, r2)))
    return noise


# (joint, accum_iter, accum_2d, use_premask, a remat model2d); the first
# three keep the ids they had before the options were ported
STEP_CASES = [
    pytest.param(False, 1, 1, False, False, id="False-1"),
    pytest.param(False, 2, 1, False, False, id="False-2"),
    pytest.param(True, 1, 1, False, False, id="True-1"),
    pytest.param(False, 1, 1, True, False, id="premask"),
    pytest.param(False, 2, 1, True, False, id="premask-accum_iter2"),
    pytest.param(True, 1, 2, False, False, id="accum_2d2"),
    pytest.param(True, 1, 2, True, True, id="accum_2d2-remat2d-premask"),
]


@pytest.mark.parametrize("joint,accum_iter,accum_2d,premask,remat2d",
                         STEP_CASES)
def test_two_train_steps_match_jax(joint, accum_iter, accum_2d, premask,
                                   remat2d):
    """The in-step pre-mask is computed by both packages from their own
    patch embeddings (geometry (a): 4x4 patches a frame, every patch row
    a border row, so each frame tops up to L/2 by score).  With
    ``accum_2d`` the 2D batch is [accum_2d, 1, ...]; a remat model2d is
    JAX's remat=True module on the same params and the port's
    ``with_remat()`` twin."""
    kw = model_kw("a")
    b3 = volume("a", b=2, seed=21)
    b2 = volume("a", b=2, frames=3, seed=22, high_res=True) if joint else None
    if accum_iter > 1:
        b3 = b3.reshape(accum_iter, 1, *b3.shape[1:])
    if accum_2d > 1:
        b2 = b2.reshape(accum_2d, 1, *b2.shape[1:])
    jm, params = jax_init(kw, volume("a"), 0.9)
    jm2d = (jmae.MaskedAutoencoderViT3D(**kw, attn_impl="flash", remat=True)
            if remat2d else None)
    tx_j = jopt.build_fused_adamw(params, 1e-3, weight_decay=0.05, eps=EPS)
    s_j = JState.create(params, tx_j, jax.random.key(2))
    step_j = jeng.make_mae_train_step(jm, tx_j, joint=joint,
                                      use_premask=premask,
                                      accum_iter=accum_iter, donate=False,
                                      model2d=jm2d, accum_2d=accum_2d)

    tm = torch_model(kw, params)
    tx_t = topt.build_fused_adamw(tm, 1e-3, weight_decay=0.05, eps=EPS)
    s_t = TState.create(tm, tx_t, seed=0)
    step_t = teng.make_mae_train_step(
        tm, tx_t, joint=joint, use_premask=premask, accum_iter=accum_iter,
        model2d=tm.with_remat() if remat2d else None, accum_2d=accum_2d)
    x3 = torch.from_numpy(b3)
    x2 = torch.from_numpy(b2) if joint else None
    for i in range(2):
        noise = _replay_noise(jm, s_j.params, s_j.rng, b3, b2, accum_iter,
                              joint, accum_2d)
        s_j, m_j = step_j(s_j, jnp.asarray(b3), mask_ratio=0.9,
                          batch2d=jnp.asarray(b2) if joint else None,
                          mask_ratio_2d=0.75)
        s_t, m_t = step_t(s_t, x3, 0.9, x2, 0.75, noise=noise)
        for k in ("loss", "loss_3d", "loss_2d", "grad_norm", "frame_losses"):
            np.testing.assert_allclose(m_t[k].numpy(), np.asarray(m_j[k]),
                                       **TOL_METRIC, err_msg=f"step {i} {k}")
        ref = state_dict_from_jax(s_j.params)
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                       **TOL_PARAM, err_msg=f"step {i} {name}")
    assert s_t.step == 2 and tx_t.count == 2
    # no gradient reaches the high-res embed of a 3D-only step, yet weight
    # decay moves it, as in JAX
    if not joint:
        w0 = state_dict_from_jax(params)["high_res_patch_embed.proj.weight"]
        assert not torch.equal(tm.high_res_patch_embed.proj.weight.detach(), w0)


def test_explicit_pre_mask_matches_jax():
    """A pre_mask passed to the step is used as given, as in JAX."""
    kw = model_kw("a")
    b3 = volume("a", b=2, seed=24)
    pm = (np.random.default_rng(3).random((2, 128)) > 0.5).astype(np.float32)
    jm, params = jax_init(kw, volume("a"), 0.9)
    tx_j = jopt.build_fused_adamw(params, 1e-3, weight_decay=0.05, eps=EPS)
    s_j = JState.create(params, tx_j, jax.random.key(2))
    noise = _replay_noise(jm, s_j.params, s_j.rng, b3, None, 1, False)
    step_j = jeng.make_mae_train_step(jm, tx_j, donate=False)
    s_j, m_j = step_j(s_j, jnp.asarray(b3), 0.9, None, 0.75, jnp.asarray(pm))
    tm = torch_model(kw, params)
    tx_t = topt.build_fused_adamw(tm, 1e-3, weight_decay=0.05, eps=EPS)
    step_t = teng.make_mae_train_step(tm, tx_t)
    _, m_t = step_t(TState.create(tm, tx_t, seed=0), torch.from_numpy(b3),
                    0.9, pre_mask=torch.from_numpy(pm), noise=noise)
    np.testing.assert_allclose(m_t["loss"].numpy(), np.asarray(m_j["loss"]),
                               **TOL_METRIC)
    with pytest.raises(ValueError, match="use_premask=True"):
        teng.make_mae_train_step(tm, tx_t, accum_iter=2)(
            TState.create(tm, tx_t, seed=0), torch.from_numpy(b3)[None],
            pre_mask=torch.from_numpy(pm))


@pytest.mark.parametrize("kw", [dict(accum_iter=2, accum_2d=2, joint=True),
                                dict(accum_2d=2)])
def test_option_exclusivity_matches_jax(kw):
    """The same options are refused by both steps, with JAX's message."""
    mkw = model_kw("a")
    jm, params = jax_init(mkw, volume("a"), 0.9)
    with pytest.raises(ValueError) as jerr:
        jeng.make_mae_train_step(jm, jopt.build_fused_adamw(params, 1e-3),
                                 donate=False, **kw)
    tm = torch_model(mkw, params)
    with pytest.raises(ValueError) as terr:
        teng.make_mae_train_step(tm, topt.build_fused_adamw(tm, 1e-3), **kw)
    assert str(terr.value) == str(jerr.value)


def test_model2d_must_share_params():
    """A model2d with parameters of its own would train nothing: refused."""
    kw = model_kw("a")
    _, params = jax_init(kw, volume("a"), 0.9)
    tm = torch_model(kw, params)
    tx = topt.build_fused_adamw(tm, 1e-3)
    with pytest.raises(ValueError, match="parameter objects"):
        teng.make_mae_train_step(tm, tx, joint=True,
                                 model2d=torch_model(dict(kw, remat=True),
                                                     params))
    teng.make_mae_train_step(tm, tx, joint=True, model2d=tm.with_remat())


def test_train_step_draws_noise_from_the_state_generator():
    """Without given noise, two states seeded alike take the same step,
    and the eval step runs in eval mode without gradients."""
    kw = model_kw("a")
    _, params = jax_init(kw, volume("a"), 0.9)
    x = torch.from_numpy(volume("a", seed=23))
    losses = []
    for _ in range(2):
        tm = torch_model(kw, params)
        tx = topt.build_adamw(tm, 1e-3)
        state = TState.create(tm, tx, seed=5)
        state, m = teng.make_mae_train_step(tm, tx)(state, x, 0.9)
        losses.append(m["loss"].item())
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    out = teng.make_mae_eval_step(tm)(x, generator=torch.Generator().manual_seed(0))
    assert not tm.training and not out["loss"].requires_grad
    assert out["pred"].shape == (2, 128, 3 * 16 * 16)
    # the options once refused are built now (their parity: above)
    teng.make_mae_train_step(tm, tx, use_premask=True)
    teng.make_mae_train_step(tm, tx, joint=True, accum_2d=2)
    with pytest.raises(ValueError, match="exclusive"):
        teng.make_mae_train_step(tm, tx, joint=True, accum_2d=2, accum_iter=2)


# ------------------------------------------- the step's CUDA graph (CPU)

def test_adamw_device_count_matches_the_host_count():
    """The count is one 0-d int64 tensor on the params' device for the
    optimizer's life, and holds what a host would count: the kept
    updates.  Updates plain and gated (``ok`` true) advance it in place
    and agree (5 steps of warmup_half_cosine, weight decay, layer
    scales); a gated update with ``ok`` false leaves it, the params and
    the moments as they were; a restore writes into it, from an ``int``
    count (older checkpoints) and from a tensor."""
    torch.manual_seed(0)
    a = torch.nn.Sequential(torch.nn.Linear(8, 6), torch.nn.LayerNorm(6),
                            torch.nn.Linear(6, 3))
    b = torch.nn.Sequential(torch.nn.Linear(8, 6), torch.nn.LayerNorm(6),
                            torch.nn.Linear(6, 3))
    b.load_state_dict(a.state_dict())
    sched = tsched.warmup_half_cosine(1e-2, 1e-4, 1, 3, 2)
    scales = {n: 0.4 + 0.2 * i for i, (n, _) in
              enumerate(a.named_parameters())}
    ta = topt.AdamW(a, sched, 0.05, scales=scales)
    tb = topt.AdamW(b, sched, 0.05, scales=scales)
    count = tb.count
    assert (count.shape, count.dtype, count.device) == (
        (), torch.int64, b[0].weight.device)
    for i in range(5):
        for m in (a, b):
            g = torch.Generator().manual_seed(i)
            for p in m.parameters():
                p.grad = torch.randn(p.shape, generator=g)
        ta.step()
        tb.step(ok=torch.tensor(True) if i % 2 else None)
        assert tb.count is count and int(count) == i + 1
        for p, q in zip(a.parameters(), b.parameters()):
            torch.testing.assert_close(q, p, rtol=1e-6, atol=1e-7)
    for m, n in zip(ta.mu + ta.nu, tb.mu + tb.nu):
        torch.testing.assert_close(n, m, rtol=1e-6, atol=1e-9)
    held = [t.clone() for t in [*b.parameters(), *tb.mu, *tb.nu]]
    tb.step(ok=torch.tensor(False))
    assert tb.count is count and int(count) == 5
    assert all(torch.equal(x, y)
               for x, y in zip(held, [*b.parameters(), *tb.mu, *tb.nu]))
    tb.load_state_dict({**ta.state_dict(), "count": 3})
    assert tb.count is count and int(count) == 3
    tb.load_state_dict(ta.state_dict())
    assert tb.count is count and int(count) == 5


class _Mesh:
    """A stand-in ``DeviceMesh``: its size, its axis names and one group
    token per axis; ``backends`` maps a token (None: the default group)
    to the backend that the patched ``dist.get_backend`` gives it."""

    def __init__(self, shape=(), names=(), backends=None):
        self.shape, self.mesh_dim_names = shape, names
        self.backends = backends or {}

    def size(self):
        return int(np.prod(self.shape))

    def get_group(self, name):
        return name

    def get_backend(self, group=None):
        return self.backends[group]


def test_the_graph_engages_only_on_one_unsharded_card_rank():
    """On one rank the step replays a graph only for a CUDA batch, no mesh
    or a mesh of one rank, an unsharded state and no profiler recording
    (several ranks: ``test_the_graph_engage_rule``)."""
    from torch.profiler import ProfilerActivity, profile

    from octcubem_tpu_torch.train import step_graph

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert step_graph.engages(cuda)
    assert step_graph.engages(cuda, _Mesh((1, 1)))
    assert not step_graph.engages(cpu)
    assert not step_graph.engages(cuda, None, shards=object())
    with profile(activities=[ProfilerActivity.CPU]):
        assert not step_graph.engages(cuda)
    assert step_graph.engages(cuda)


_NCCL4 = {None: "nccl", "data": "nccl", "fsdp": "nccl"}


@pytest.mark.parametrize("device, mesh, shards, profiled, engages", [
    ("cuda", None, None, False, True),
    ("cuda", _Mesh((1, 1), ("data", "fsdp"), {None: "gloo"}), None, False,
     True),
    ("cuda", _Mesh((4, 1), ("data", "fsdp"), _NCCL4), None, False, True),
    ("cpu", None, None, False, False),
    ("cpu", _Mesh((4, 1), ("data", "fsdp"), _NCCL4), None, False, False),
    ("cuda", _Mesh((4, 1), ("data", "fsdp"), dict.fromkeys(_NCCL4, "gloo")),
     None, False, False),
    ("cuda", _Mesh((4, 1), ("data", "fsdp"), {**_NCCL4, "fsdp": "gloo"}),
     None, False, False),
    ("cuda", _Mesh((1, 1, 4), ("data", "fsdp", "sp"),
                   {**_NCCL4, "sp": "nccl"}), None, False, False),
    ("cuda", _Mesh((2, 2), ("data", "fsdp"), _NCCL4), object(), False,
     False),
    ("cuda", _Mesh((4, 1), ("data", "fsdp"), _NCCL4), None, True, False),
], ids=["no_mesh", "one_rank", "nccl_data4", "cpu", "cpu_nccl_mesh",
        "gloo", "one_gloo_axis", "sp_axis", "sharded", "profiled"])
def test_the_graph_engage_rule(device, mesh, shards, profiled, engages):
    """Where the MAE step replays a graph, from what it can observe: a
    CUDA batch, an unsharded state, no profiler recording, and no mesh, a
    mesh of one rank or a mesh of several ranks with no ``sp`` axis whose
    groups (the default one and each axis's) are all NCCL.  Stand-in
    meshes: no process group forms."""
    from unittest import mock

    from octcubem_tpu_torch.train import step_graph

    backend = mesh.get_backend if mesh is not None else None
    with mock.patch.object(step_graph.dist, "get_backend", backend), \
            mock.patch.object(step_graph.profiling, "recording",
                              lambda: profiled):
        assert step_graph.engages(torch.device(device), mesh,
                                  shards) is engages


def test_shutdown_drops_captured_graphs_first():
    """``multihost.shutdown`` empties every ``StepGraphs`` of the process
    before it destroys the group: NCCL's destroy waits until the graphs
    that captured the group's collectives are gone."""
    from unittest import mock

    from octcubem_tpu_torch.core import multihost
    from octcubem_tpu_torch.train import step_graph

    graphs = step_graph.StepGraphs([torch.zeros(1)])
    graphs.graphs["key"] = graphs.last = object()
    left = []
    with mock.patch.object(multihost.dist, "is_initialized", lambda: True), \
            mock.patch.object(multihost.dist, "destroy_process_group",
                              lambda: left.append(dict(graphs.graphs))):
        multihost.shutdown()
    assert left == [{}] and graphs.last is None


def test_a_remat_block_with_drop_path_is_not_captured():
    """``step_graph.capturable``: a model is, and so is its remat twin
    without drop path; with drop path its checkpointed blocks' recompute
    makes a generator, which no capture allows."""
    from octcubem_tpu_torch.train import step_graph

    kw = model_kw("a")
    plain = tmae.MaskedAutoencoderViT3D(**kw)
    dropped = tmae.MaskedAutoencoderViT3D(**kw, drop_path_rate=0.1)
    assert step_graph.capturable(plain, plain.with_remat())
    assert step_graph.capturable(dropped)
    assert not step_graph.capturable(dropped, dropped.with_remat())


def test_successive_steps_return_their_own_metrics():
    """Two calls of one step: distinct metric tensors, the first call's
    unchanged by the second; both eager on the CPU."""
    from octcubem_tpu_torch.utils import profiling

    kw = model_kw("a")
    _, params = jax_init(kw, volume("a"), 0.9)
    x = torch.from_numpy(volume("a", seed=23))
    tm = torch_model(kw, params)
    tx = topt.build_adamw(tm, 1e-3)
    state = TState.create(tm, tx, seed=5)
    step = teng.make_mae_train_step(tm, tx)
    seen = profiling.last_seq()
    state, m1 = step(state, x, 0.9)
    kept = {k: v.clone() for k, v in m1.items()}
    state, m2 = step(state, x, 0.9)
    for k in m1:
        assert m1[k] is not m2[k] and m1[k].data_ptr() != m2[k].data_ptr()
        assert torch.equal(m1[k], kept[k])
    assert not torch.equal(m1["loss"], m2["loss"])
    assert [r["path"] for r in profiling.records_since(seen)] == ["eager"] * 2
    assert int(tx.count) == 2
