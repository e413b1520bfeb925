"""Port parity: FocalNet, the Perceiver and the HuggingFace text tower
(models/aux_towers.py), and the COEM factory's aux-tower selectors
(models/coem.py), against the JAX package on the CPU.

Both packages run the same seeded random weights (in the JAX init's
tree, carried by ``state_dict_from_jax`` with ``strict=True``) on the
same seeded numpy
inputs in fp32, in eval mode (drop path off).  Outputs within TOL (1e-5);
gradients of a fixed random projection of the output, leaf by leaf,
within TOL_GRAD (1e-4 of the leaf's largest JAX gradient, plus 1e-4
relative).  A COEP2Tower with a HIPT ViT-4K (257 tokens, 2 heads of 16:
the JAX flash kernels in interpret mode, the port's plain B3 / B4) and a
CLIP text tower takes one ``make_clip_train_step`` step in each package
at Adam eps 1e-3 (as test_torch_port_clip_steps.py, which says why):
loss and grad norm within TOL_LOSS, every param after it within
TOL_PARAM.  Both packages refuse to train a ModifiedResNet tower through
the COEM step (its BatchNorm statistics have nowhere to go)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from transformers import BertConfig

from octcubem_tpu.models import aux_towers as jaux
from octcubem_tpu.models import coem as jcoem
from octcubem_tpu.train import clip_engine as jeng
from octcubem_tpu.train import optim as joptim
from octcubem_tpu.train.train_state import TrainState as JState
from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.models import aux_towers as taux
from octcubem_tpu_torch.models import coem as tcoem
from octcubem_tpu_torch.train import clip_engine as teng
from octcubem_tpu_torch.train import optim as toptim
from octcubem_tpu_torch.train.train_state import TrainState

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_GRAD = 1e-4
TOL_LOSS = dict(rtol=1e-5, atol=1e-6)
TOL_PARAM = dict(rtol=1e-5, atol=2e-6)


def _variables(jm, *args, seed=1, **kw):
    """Seeded random variables in the tree ``jm.init`` would make (its
    shapes from ``jax.eval_shape``, no init compiled): kernels, tables and
    embeddings N(0, 1 / fan_in) with fan_in all but the last axis; scales
    and variances 1 + 0.05 N(0, 1); biases and means 0.05 N(0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(functools.partial(jm.init, **kw),
                            jax.random.key(0), *args)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if len(leaf.shape) >= 2:
            return z / np.sqrt(np.prod(leaf.shape[:-1]))
        return 1.0 + 0.05 * z if name in ("scale", "var") else 0.05 * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **TOL)


def _pair(jcls, tcls, args, kw, init_kw=None):
    """(JAX module, seeded variables, the port's module loaded strictly
    with them, in eval mode)."""
    jm = jcls(**kw)
    v = _variables(jm, *args, **(init_kw or {}))
    tm = tcls(**kw)
    tm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, v, tm.eval()


def _check(jm, v, tm, args, what, grads=True, **call_kw):
    """Outputs within TOL; with ``grads`` the per-leaf gradients of
    sum(out * r) within TOL_GRAD (a leaf that is 0 in exact arithmetic
    floored at 1e-3 of the largest)."""
    targs = [None if a is None else torch.from_numpy(np.asarray(a))
             for a in args]
    want = jax.jit(functools.partial(jm.apply, **call_kw))(v, *args)
    tm.zero_grad(set_to_none=True)
    got = tm(*targs, **call_kw)
    _close(got, want, what)
    if not grads:
        return
    r = np.random.default_rng(7).standard_normal(np.shape(want)).astype(
        np.float32)

    def loss(p):
        return jnp.sum(jm.apply(p, *args, **call_kw) * r)

    gw = state_dict_from_jax(jax.jit(jax.grad(loss))(v))
    (got * torch.from_numpy(r)).sum().backward()
    gt = {k: p.grad for k, p in tm.named_parameters()}
    assert set(gt) == set(gw), what
    top = max(float(w.abs().max()) for w in gw.values())
    for k, w in gw.items():
        w = w.numpy()
        if gt[k] is None:  # no path to the output (BERT's pooler)
            assert not w.any(), f"{what}: no gradient for {k}"
            continue
        np.testing.assert_allclose(
            gt[k].numpy(), w, rtol=TOL_GRAD,
            atol=TOL_GRAD * max(float(np.abs(w).max()), 1e-3 * top),
            err_msg=f"{what}: {k}")


# ---------------------------------------------------------------- FocalNet

FOCAL_CASES = {
    "tiny_srf_layerscale": ("focalnet_tiny_srf", {}),
    "conv_embed_postln": ("focalnet_tiny_srf",
                          {"use_conv_embed": True, "use_postln": True,
                           "use_layerscale": False}),
    "tiny_lrf": ("focalnet_tiny_lrf", {}),
}


@pytest.mark.parametrize("case", list(FOCAL_CASES))
def test_focalnet_tower_matches_jax(case):
    """Each option on a 32 px image, embed 8, one block a stage (4 -> 2 ->
    1 px maps past the stem): depthwise SAME convs, layerscale, post-LN,
    the conv and non-conv embeds, 2 and 3 focal levels."""
    name, opts = FOCAL_CASES[case]
    x = np.random.default_rng(0).random((2, 32, 32, 3), np.float32)
    kw = dict(out_dim=16, model_name=name,
              trunk_cfg=dict(embed_dim=8, depths=(1, 1, 1, 1), img_size=32,
                             **opts))
    jm, v, tm = _pair(jaux.FocalNetTower, taux.FocalNetTower, (x,), kw)
    _check(jm, v, tm, (x,), case)


def test_focalnet_drop_path_schedule():
    """The linear stochastic-depth schedule over all blocks, as the JAX
    trunk's (rate * index / (total - 1))."""
    m = taux.focalnet_tiny_srf(embed_dim=8, depths=(1, 2, 1, 1))
    rates = [getattr(m, f"layers_{i}_blocks_{j}").drop_path1.rate
             for i, d in enumerate(m.depths) for j in range(d)]
    np.testing.assert_allclose(rates, [0.2 * i / 4 for i in range(5)])


# --------------------------------------------------------------- Perceiver

PERCEIVER_CFG = dict(num_latents=4, num_latent_channels=16,
                     num_image_channels=12, num_cross_attention_heads=2,
                     num_self_attention_heads=2, num_self_attention_layers=1)


@pytest.mark.parametrize("case", ["coords", "default_coords", "pad_mask",
                                  "map_input_proj"])
def test_perceiver_tower_matches_jax(case):
    """Feature bags of 10 x 12 with pixel coords (tile indices up to 40,
    some past the 1,000-tile grid, clamped), with the default row-major
    coords, with a pad mask (the last 3 features padded in one bag), and a
    [B, 2, 5, 12] map into a tower whose latents (16) are projected to
    out_dim 24."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 10, 12)).astype(np.float32)
    coords = pad = None
    out_dim = 16
    if case == "coords":
        coords = (rng.integers(0, 40, (2, 10, 2)) * 256
                  + rng.integers(0, 256, (2, 10, 2))).astype(np.float32)
        coords[0, 0] = 300000.0
    if case == "pad_mask":
        pad = np.zeros((2, 10), np.float32)
        pad[1, 7:] = 1.0
    if case == "map_input_proj":
        x = x.reshape(2, 2, 5, 12)
        out_dim = 24
    kw = dict(out_dim=out_dim, cfg=PERCEIVER_CFG)
    jm, v, tm = _pair(jaux.PerceiverTower, taux.PerceiverTower, (x,), kw,
                      init_kw=dict(coords=coords, pad_mask=pad))
    jcall = functools.partial(jm.apply, deterministic=True, coords=coords,
                              pad_mask=pad)
    want = jax.jit(jcall)(v, x)
    t = {k: None if a is None else torch.from_numpy(a)
         for k, a in (("coords", coords), ("pad_mask", pad))}
    got = tm(torch.from_numpy(x), **t)
    _close(got, want, case)
    r = np.random.default_rng(7).standard_normal(np.shape(want)).astype(
        np.float32)
    gw = state_dict_from_jax(jax.jit(jax.grad(
        lambda p: jnp.sum(jcall(p, x) * r)))(v))
    (got * torch.from_numpy(r)).sum().backward()
    top = max(float(w.abs().max()) for w in gw.values())
    for k, p in tm.named_parameters():
        w = gw[k].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=TOL_GRAD,
            atol=TOL_GRAD * max(float(np.abs(w).max()), 1e-3 * top),
            err_msg=f"{case}: {k}")


# ---------------------------------------------------------- HF text tower

def _bert():
    return BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=64,
                      max_position_embeddings=32, pad_token_id=0)


def _ids():
    ids = np.random.default_rng(0).integers(1, 64, (2, 8)).astype(np.int32)
    ids[0, 5:] = 0  # a padded tail
    return ids


@pytest.mark.parametrize("pooler,proj", [
    ("mean_pooler", "linear"), ("mean_pooler", "mlp"),
    ("cls_pooler", "linear"), ("cls_pooler", "mlp")])
def test_hf_text_tower_matches_jax(pooler, proj):
    """A tiny BertConfig, the Flax BERT tree carried onto the torch BERT
    state dict: both poolers (the pad-masked mean, the first token) and
    both bias-free projections; gradients for the mean pooler."""
    ids = _ids()
    kw = dict(output_dim=16, hf_config=_bert(), pooler_type=pooler, proj=proj)
    jm, v, tm = _pair(jaux.HFTextTower, taux.HFTextTower, (ids,), kw)
    _check(jm, v, tm, (ids,), f"{pooler} {proj}",
           grads=pooler == "mean_pooler")


def test_hf_text_tower_names_its_package_when_missing(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        taux.HFTextTower(output_dim=16, hf_config=_bert())


# ------------------------------------------------- the COEM selectors

HIPT = dict(hipt=True, input_embed_dim=24, output_embed_dim=32, depth=1,
            num_heads=2, img_size=64)
TEXT = dict(text=True, vocab_size=100, context_length=12, width=32, depth=1,
            heads=2)
SELECTORS = {
    "resnet_layers": ("vision", dict(layers=[1, 1, 1, 1], width=8, heads=2,
                                     image_size=64),
                      taux.ModifiedResNet, (2, 64, 64, 3)),
    "hipt": ("vision", HIPT, taux.VisionTransformer4K, (2, 4, 4, 24)),
    "tower_focalnet": ("vision", dict(tower="focalnet", embed_dim=8,
                                      depths=[1, 1, 1, 1], img_size=32),
                       taux.FocalNetTower, (2, 32, 32, 3)),
    "model_name_focalnet": ("vision", dict(model_name="focalnet_tiny_lrf",
                                           embed_dim=8, depths=[1, 1, 1, 1]),
                            taux.FocalNetTower, (2, 32, 32, 3)),
    "tower_perceiver": ("vision", dict(tower="perceiver", **PERCEIVER_CFG),
                        taux.PerceiverTower, (2, 10, 12)),
    "model_name_perceiver": ("vision", dict(model_name="perceiver",
                                            **PERCEIVER_CFG),
                             taux.PerceiverTower, (2, 10, 12)),
    "text": ("enface", TEXT, taux.TextTransformer, None),
    "hf_config": ("enface", dict(hf_config=_bert()), taux.HFTextTower, None),
}


@pytest.mark.parametrize("sel", list(SELECTORS))
def test_coem_selector_builds_the_same_tower(sel):
    """Each selector in a COEP2Tower (the other slot a HIPT or a text
    tower): the same tower class, the same parameter tree (strict load)
    and the same features, in both packages."""
    slot, cfg, tcls, shape = SELECTORS[sel]
    rng = np.random.default_rng(2)
    tokens = rng.integers(1, 60, (2, 12)).astype(np.int32)
    tokens[:, 9], tokens[:, 10:] = 63, 0  # eot (the largest id), pad
    if slot == "vision":
        vcfg, ecfg = cfg, TEXT
        img = rng.random(shape, np.float32)
    else:
        vcfg, ecfg = HIPT, cfg
        img = rng.random((2, 4, 4, 24), np.float32)
    kw = dict(embed_dim=16, vision_cfg=vcfg, enface_cfg=ecfg)
    jm, v, tm = _pair(jcoem.COEP2Tower, tcoem.COEP2Tower, (img, tokens), kw)
    tower = tm.visual if slot == "vision" else tm.enface.tower
    assert isinstance(tower, tcls)
    want = jax.jit(jm.apply)(v, img, tokens)
    with torch.no_grad():
        got = tm(torch.from_numpy(img), torch.from_numpy(tokens))
    for name, g, w in zip(("image", "enface", "scale"), got, want):
        _close(g, w, f"{sel}: {name}")


# --------------------------------------- the HIPT <-> text pair's step

def _hipt_text_batch(seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 90, (4, 12)).astype(np.int32)
    tokens[:, 0] = 98
    for i, n in enumerate((11, 6, 9, 4)):
        tokens[i, n], tokens[i, n + 1:] = 99, 0
    return {"image": rng.standard_normal((4, 16, 16, 24)).astype(np.float32),
            "enface": tokens}


@functools.lru_cache(maxsize=None)
def _hipt_text_step():
    """One make_clip_train_step step of a COEP2Tower (HIPT ViT-4K at 2
    heads of 16 on a 16 x 16 map, 257 tokens; CLIP text transformer) in
    each package from the same perturbed weights: (JAX loss, grad norm,
    params; the port's; the port's start state dict)."""
    kw = dict(embed_dim=16, vision_cfg=dict(HIPT, img_size=256, depth=2),
              enface_cfg=dict(TEXT, depth=2))
    b0 = _hipt_text_batch(0)
    jm, v, tm = _pair(jcoem.COEP2Tower, tcoem.COEP2Tower,
                      (b0["image"], b0["enface"]), kw)
    tx = optax.chain(
        optax.scale_by_adam(b1=0.9, b2=0.98, eps=1e-3),
        optax.add_decayed_weights(0.1, joptim.weight_decay_mask(v)),
        optax.scale_by_learning_rate(1e-3))
    state = JState.create(v, tx, jax.random.key(2))
    batch = _hipt_text_batch(3)
    state, m = jeng.make_clip_train_step(jm, tx)(
        state, {k: jnp.asarray(a) for k, a in batch.items()})
    jout = (float(m["loss"]), float(m["grad_norm"]),
            state_dict_from_jax(jax.tree.map(np.asarray, state.params)))
    ttx = toptim.AdamW(tm, 1e-3, 0.1, betas=(0.9, 0.98), eps=1e-3)
    tstate = TrainState.create(tm, ttx, 2)
    start = {k: p.clone() for k, p in tm.state_dict().items()}
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    tstate, tm_ = teng.make_clip_train_step(tm, ttx)(tstate, tb)
    assert tb["enface"].dtype == torch.int32  # tokens stay integers
    tout = (tm_["loss"].item(), tm_["grad_norm"].item(),
            {k: p.clone() for k, p in tm.state_dict().items()})
    return jm, v, tm, jout, tout, start


def test_hipt_text_pair_forward_matches_jax():
    jm, v, _, _, _, start = _hipt_text_step()
    kw = dict(embed_dim=16, vision_cfg=dict(HIPT, img_size=256, depth=2),
              enface_cfg=dict(TEXT, depth=2))
    tm = tcoem.COEP2Tower(**kw)
    tm.load_state_dict(start, strict=True)
    b = _hipt_text_batch(5)
    want = jax.jit(jm.apply)(v, b["image"], b["enface"])
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(b["image"]),
                        torch.from_numpy(b["enface"]))
    for name, g, w in zip(("image", "enface", "scale"), got, want):
        _close(g, w, name)


def test_hipt_text_pair_train_step_matches_jax():
    _, _, _, (jl, jg, jp), (tl, tg, tp), _ = _hipt_text_step()
    np.testing.assert_allclose(tl, jl, err_msg="loss", **TOL_LOSS)
    np.testing.assert_allclose(tg, jg, err_msg="grad norm", **TOL_LOSS)
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), jp[k].numpy(),
                                   err_msg=k, **TOL_PARAM)


def test_both_packages_refuse_the_resnet_train_step():
    """The COEM step applies the model in training mode without mutable
    BatchNorm statistics: flax refuses to write batch_stats, the port's
    ModifiedResNet refuses a training-mode call without mutable=True."""
    vcfg = SELECTORS["resnet_layers"][1]
    kw = dict(embed_dim=16, vision_cfg=vcfg, enface_cfg=TEXT)
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, 60, (2, 12)).astype(np.int32)
    tokens[:, 9], tokens[:, 10:] = 63, 0
    batch = {"image": rng.random((2, 64, 64, 3), np.float32),
             "enface": tokens}
    jm, v, tm = _pair(jcoem.COEP2Tower, tcoem.COEP2Tower,
                      (batch["image"], tokens), kw)
    tx = optax.adam(1e-3)
    state = JState.create(v, tx, jax.random.key(0))
    with pytest.raises(Exception, match="batch_stats"):
        jeng.make_clip_train_step(jm, tx)(
            state, {k: jnp.asarray(a) for k, a in batch.items()})
    ttx = toptim.AdamW(tm, 1e-3, 0.1)
    step = teng.make_clip_train_step(tm, ttx)
    with pytest.raises(RuntimeError, match="BatchNorm tower"):
        step(TrainState.create(tm, ttx, 0),
             {k: torch.from_numpy(a) for k, a in batch.items()})
