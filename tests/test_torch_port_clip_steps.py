"""Port parity: the contrastive train steps (train/clip_engine.py) against
the JAX package's jitted steps on the CPU, two steps each from the same
perturbed weights and seeded batches: the plain 2-tower step under the
partition lock and the zero-scale fallback, the feature-cached
accumulation (2-tower and 3-modality, with absent FAF), and the
classification step with the lock under the 'clip.visual.' prefix.

The OCT tower is 6 x 128 x 128 (129 tokens: the cls-fold branch of B1 /
B2's plain versions), the en face tower 48 x 48 (10 tokens, unfolded).
Loss and grad norm within TOL_LOSS, every param after each step within
TOL_PARAM; under the partition lock the frozen params equal their start
bit for bit and the optimizer holds no moments for them.  Adam runs at
eps 1e-3 on both sides: its first update is lr * g / (|g| + eps), which
at a smaller eps turns a 1e-9 gradient difference at |g| ~ eps into a
~1e-3 relative step difference; at 1e-3 a param's difference after a
step is about the gradient's own, so TOL_PARAM holds the gradients to
~2e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from octcubem_tpu.models import coem as jcoem
from octcubem_tpu.train import clip_engine as jeng
from octcubem_tpu.train import losses as jlosses
from octcubem_tpu.train import optim as joptim
from octcubem_tpu.train.train_state import TrainState as JState
from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.models import coem as tcoem
from octcubem_tpu_torch.train import clip_engine as teng
from octcubem_tpu_torch.train import losses as tlosses
from octcubem_tpu_torch.train import optim as toptim
from octcubem_tpu_torch.train.train_state import TrainState

VCFG = dict(num_frames=6, t_patch_size=3, img_size=128, patch_size=16,
            in_chans=1, embed_dim=32, depth=2, num_heads=2)
ECFG = dict(img_size=48, patch_size=16, in_chans=3, embed_dim=32, depth=2,
            num_heads=2)
EDIM, EPS, LR, WD, UNLOCKED = 16, 1e-3, 1e-3, 0.1, 2
TOL_LOSS = dict(rtol=1e-5, atol=1e-6)
TOL_PARAM = dict(rtol=1e-5, atol=2e-6)
ACCUM, CHUNK = 2, 2


def _batch(seed, kind):
    """A seeded batch: [ACCUM, CHUNK, ...] for the accumulation steps."""
    rng = np.random.default_rng(seed)
    lead = (ACCUM, CHUNK) if kind.startswith("accum") else (ACCUM * CHUNK,)
    b = {"image": rng.random(lead + (6, 128, 128, 1), np.float32)}
    if kind == "accum3":
        b["enface1"] = rng.random(lead + (48, 48, 3), np.float32)
        b["enface2"] = rng.random(lead + (48, 48, 3), np.float32)
        b["weight1"] = np.ones(lead, np.float32)
        b["weight2"] = (rng.random(lead) > 0.4).astype(np.float32)
    else:
        b["enface"] = rng.random(lead + (48, 48, 3), np.float32)
    if kind == "cls":
        b["label"] = rng.integers(0, 3, lead).astype(np.int32)
    return b


def _models(kind):
    kw = dict(embed_dim=EDIM, vision_cfg=VCFG, enface_cfg=ECFG)
    if kind == "accum3":
        return jcoem.COEP3Tower, tcoem.COEP3Tower, kw
    if kind == "cls":
        kw["num_classes"] = 3
        return (jcoem.COEP2TowerClassification,
                tcoem.COEP2TowerClassification, kw)
    return jcoem.COEP2Tower, tcoem.COEP2Tower, kw


def _adam(mask_params):
    return optax.chain(
        optax.scale_by_adam(b1=0.9, b2=0.98, eps=EPS),
        optax.add_decayed_weights(WD, joptim.weight_decay_mask(mask_params)),
        optax.scale_by_learning_rate(LR))


@pytest.fixture(scope="module", params=[
    ("plain", "partition"), ("plain", "zero_scale"),
    ("accum", "partition"), ("accum3", "partition"), ("cls", "partition")],
    ids=lambda p: "-".join(p))
def runs(request):
    """Both packages' two steps: (kind, lock, JAX (loss, grad_norm,
    params) per step, the port's, the port's frozen names and start)."""
    kind, lock = request.param
    jcls, tcls, kw = _models(kind)
    jm = jcls(**kw, attn_impl="naive")
    b0 = _batch(0, kind)
    first = (lambda v: v[0]) if kind.startswith("accum") else (lambda v: v)
    names = (("image", "enface1", "enface2") if kind == "accum3"
             else ("image", "enface"))
    params = jax.jit(jm.init)(jax.random.key(0),
                              *(first(b0[k]) for k in names))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), params)
    jprefix = "clip/visual/" if kind == "cls" else "visual/"
    tprefix = "clip.visual." if kind == "cls" else "visual."
    scales = joptim.lit_lock_scales(params, VCFG["depth"], UNLOCKED, jprefix)
    partition = None
    if lock == "partition":
        partition = joptim.make_partition(jax.tree.map(lambda s: s > 0,
                                                       scales))
        tr0, _ = partition[0](params)
        tx = _adam(tr0)
        state = JState.create(params, tx, jax.random.key(2), tx_params=tr0)
    else:
        tx = optax.chain(_adam(params), joptim.scale_by_tree(scales))
        state = JState.create(params, tx, jax.random.key(2))
    if kind == "plain":
        jstep = jeng.make_clip_train_step(jm, tx, partition=partition)
    elif kind == "accum":
        jstep = jeng.make_clip_accum_train_step(jm, tx, ACCUM,
                                                partition=partition)
    elif kind == "accum3":
        jstep = jeng.make_clip_accum_train_step_3mod(jm, tx, ACCUM,
                                                     partition=partition)
    else:
        jstep = jeng.make_clip_cls_train_step(jm, tx, jlosses.softmax_ce,
                                              partition=partition)
    jout = []
    for seed in (3, 4):
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in
                                 _batch(seed, kind).items()})
        jout.append((float(m["loss"]), float(m["grad_norm"]),
                     state_dict_from_jax(jax.tree.map(np.asarray,
                                                      state.params))))

    tm = tcoem.create_model(tcls, device="cpu", **kw)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    tscales = toptim.lit_lock_scales(tm, VCFG["depth"], UNLOCKED, tprefix)
    if lock == "partition":
        trainable = toptim.make_partition(
            tm, {k: s > 0 for k, s in tscales.items()})
        ttx = toptim.AdamW(trainable, LR, WD, betas=(0.9, 0.98), eps=EPS)
    else:
        ttx = toptim.scale_by_tree(
            toptim.AdamW(tm, LR, WD, betas=(0.9, 0.98), eps=EPS), tscales)
    tstate = TrainState.create(tm, ttx, 2)
    if kind == "plain":
        tstep = teng.make_clip_train_step(tm, ttx)
    elif kind == "accum":
        tstep = teng.make_clip_accum_train_step(tm, ttx, ACCUM)
    elif kind == "accum3":
        tstep = teng.make_clip_accum_train_step_3mod(tm, ttx, ACCUM)
    else:
        tstep = teng.make_clip_cls_train_step(tm, ttx, tlosses.softmax_ce)
    frozen = {k for k, s in tscales.items() if s == 0}
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    tout = []
    for seed in (3, 4):
        tb = {k: torch.from_numpy(v) for k, v in _batch(seed, kind).items()}
        tstate, m = tstep(tstate, tb)
        tout.append((m["loss"].item(), m["grad_norm"].item(),
                     {k: v.clone() for k, v in tm.state_dict().items()}))
    return kind, lock, jout, tout, frozen, start, ttx, tstate


def test_two_steps_match_jax(runs):
    kind, lock, jout, tout, _, _, _, tstate = runs
    assert tstate.step == 2
    for i, ((jl, jg, jp), (tl, tg, tp)) in enumerate(zip(jout, tout)):
        np.testing.assert_allclose(tl, jl, err_msg=f"loss {i}", **TOL_LOSS)
        np.testing.assert_allclose(tg, jg, err_msg=f"gnorm {i}", **TOL_LOSS)
        assert set(tp) == set(jp)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), jp[k].numpy(),
                                       err_msg=f"{k} after step {i + 1}",
                                       **TOL_PARAM)


def test_frozen_params_and_moments(runs):
    """The partition lock: frozen params bit-identical after two steps, no
    moments for them, the trainable ones moved; zero-scale: moments for
    every param, the locked ones still bit-identical."""
    kind, lock, _, tout, frozen, start, ttx, _ = runs
    assert frozen, "the lock froze nothing"
    last = tout[-1][2]
    moved = {k for k in start if not torch.equal(last[k], start[k])}
    assert not moved & frozen
    # every trainable param moved but the classifier's logit scales, which
    # its loss does not reach (and which take no weight decay)
    idle = {k for k in start if kind == "cls" and "logit_scale" in k}
    assert moved == set(start) - frozen - idle
    moments = set(ttx.state_dict()["mu"])
    if lock == "partition":
        assert not moments & frozen
        assert moments == set(start) - frozen
    else:
        assert frozen <= moments
