"""Port parity: the COEM towers (models/coem.py, the registry's JSON
configs) against the JAX package on the CPU.

Both packages run the same weights (``state_dict_from_jax`` of the JAX
init, perturbed) on the same seeded inputs, in fp32; the JAX side runs
its Pallas flash kernels in interpret mode, the port B1's plain version.
The OCT tower is 6 x 128 x 128 at patch 16, t_patch 3: 2 x 8 x 8 tubes +
cls = 129 tokens, so the cls-fold branch (n % 128 == 1) is the one
compared; the en face tower at 48 x 48 has 9 patches + cls = 10 tokens,
the unfolded branch.  Features within TOL (the port's TOL_METRIC).
test_torch_port_coem_configs.py holds the shipped configs."""

import functools

import jax
import numpy as np
import pytest
import torch

from octcubem_tpu.models import coem as jcoem
from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.models import coem as tcoem

TOL = dict(rtol=1e-5, atol=1e-5)
VCFG = dict(num_frames=6, t_patch_size=3, img_size=128, patch_size=16,
            in_chans=1, embed_dim=32, depth=2, num_heads=2)
ECFG = dict(img_size=48, patch_size=16, in_chans=3, embed_dim=32, depth=2,
            num_heads=2)
EDIM = 16


def _inputs(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return (rng.random((b, 6, 128, 128, 1), np.float32),
            rng.random((b, 48, 48, 3), np.float32),
            rng.random((b, 48, 48, 3), np.float32))


def _perturbed(variables, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        variables)


@functools.lru_cache(maxsize=None)
def _pair(kind: str):
    """(JAX module, perturbed params, port model with those weights,
    inputs)."""
    img, e1, e2 = _inputs()
    jcls, tcls = {
        "coem2": (jcoem.COEP2Tower, tcoem.COEP2Tower),
        "coem3": (jcoem.COEP3Tower, tcoem.COEP3Tower),
        "cls2": (jcoem.COEP2TowerClassification,
                 tcoem.COEP2TowerClassification),
        "cls3": (jcoem.COEP3TowerClassification,
                 tcoem.COEP3TowerClassification)}[kind]
    kw = dict(embed_dim=EDIM, vision_cfg=VCFG, enface_cfg=ECFG)
    if kind.startswith("cls"):
        kw["num_classes"] = 3
    jm = jcls(**kw, attn_impl="flash")
    args = (img, e1, e2) if kind.endswith("3") else (img, e1)
    params = _perturbed(jax.jit(jm.init)(jax.random.key(0), *args))
    tm = tcoem.create_model(tcls, device="cpu", **kw)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm, args


def _close(got, want, what):
    if want is None:
        assert got is None, what
        return
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **TOL)


@pytest.mark.parametrize("sm", [None, "image", "enface"])
def test_coep2_forward_matches_jax(sm):
    jm, params, tm, args = _pair("coem2")
    want = jax.jit(functools.partial(jm.apply, single_modality=sm))(
        params, *args)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in args), single_modality=sm)
    for name, g, w in zip(("image", "enface", "scale"), got, want):
        _close(g, w, f"{sm}: {name}")


@pytest.mark.parametrize("sm", [None, "image", "enface1", "enface2"])
def test_coep3_forward_matches_jax(sm):
    jm, params, tm, args = _pair("coem3")
    want = jax.jit(functools.partial(jm.apply, single_modality=sm))(
        params, *args)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in args), single_modality=sm)
    assert len(got) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"{sm}: output {i}")


@pytest.mark.parametrize("kind,sm", [("cls2", None), ("cls2", "image"),
                                     ("cls2", "enface"), ("cls3", None),
                                     ("cls3", "enface2")])
def test_classification_matches_jax(kind, sm):
    """Logits and scales, with the single-modality zero-fill."""
    jm, params, tm, args = _pair(kind)
    want = jax.jit(functools.partial(jm.apply, single_modality=sm))(
        params, *args)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in args), single_modality=sm)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"{kind} {sm}: output {i}")


@pytest.mark.parametrize("tower", ["vit2d", "vit_3dhead"])
def test_tower_dispatch_matches_jax(tower):
    """The 'tower' key: a RETFound 2D trunk headed to the CLIP dim, or
    the 3D pooling head over slices."""
    jm, params, tm, args = _pair_tower(tower)
    want = jax.jit(jm.apply)(params, *args)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in args))
    cls = (tcoem.VisionTransformer2D if tower == "vit2d"
           else tcoem.VisionTransformer3DHead)
    assert isinstance(tm.visual, cls)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"{tower}: output {i}")


@functools.lru_cache(maxsize=None)
def _pair_tower(tower):
    vcfg = dict(tower=tower, img_size=32, patch_size=16, in_chans=3,
                embed_dim=32, depth=2, num_heads=2)
    kw = dict(embed_dim=EDIM, vision_cfg=vcfg, enface_cfg=ECFG)
    jm = jcoem.COEP2Tower(**kw, attn_impl="flash")
    rng = np.random.default_rng(3)
    vis = rng.random((2, 32, 32, 3) if tower == "vit2d"
                     else (2, 3, 32, 32, 3), np.float32)
    args = (vis, _inputs()[1])
    params = _perturbed(jax.jit(jm.init)(jax.random.key(0), *args))
    tm = tcoem.create_model(tcoem.COEP2Tower, device="cpu", **kw)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm, args


def test_keys_are_the_jax_paths():
    """enface.mod_head_{i} (not mod_heads.i), 0-d logit scales, the
    classification models' clip.* + classification_head.*."""
    _, params, tm, _ = _pair("cls3")
    keys = set(tm.state_dict())
    assert {"clip.enface.mod_head_0.weight", "clip.enface.mod_head_1.bias",
            "clip.enface.head.weight", "clip.logit_scale2",
            "classification_head.input_norm.weight",
            "clip.visual.trunk.blocks.1.mixer.Wqkv.weight"} <= keys
    assert tm.clip.logit_scale.ndim == 0
    assert tm.classification_head.fc1.weight.shape == (EDIM, 3 * EDIM)
    assert not any("mod_heads" in k for k in keys)


def test_logit_scale_init_clamp_and_gradient():
    """ln(1/0.07) at init; exp(min(s, ln 100)) in the forward, and a
    clamped scale gets no gradient."""
    tm = tcoem.create_model(tcoem.COEP2Tower, device="cpu", embed_dim=EDIM,
                            vision_cfg=VCFG, enface_cfg=ECFG)
    assert tm.logit_scale.item() == pytest.approx(np.log(1 / 0.07), abs=1e-6)
    img, e1, _ = (torch.from_numpy(a[:1]) for a in _inputs())
    with torch.no_grad():
        tm.logit_scale.fill_(10.0)
    _, _, s = tm(img, e1, single_modality="image")
    assert s.item() == pytest.approx(100.0, rel=1e-6)
    (g,) = torch.autograd.grad(s, tm.logit_scale)
    assert g.item() == 0.0
