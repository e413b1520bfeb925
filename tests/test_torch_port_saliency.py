"""Port parity: Grad-CAM (utils/saliency.py, vit_st(capture_cam=True)),
infer --saliency_dir and the COEM pair map (clip_pair_gradcam on a
COEP2Tower(capture_cam=True)) against the JAX package on the CPU.

Both packages run the same weights (state_dict_from_jax) and input; the
JAX side differentiates its flax perturbations through the Pallas
kernels in interpret mode, the port its zero tensors through B1 / B2's
plain versions.  The maps are in [0, 1] (each sample over its max); fp32
within 1e-4.  Tiny classifier: width 64, 2 heads of 32, 2 blocks,
12 x 32 x 32 (4 x 2 x 2 tube tokens + cls).
"""

import functools
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from octcubem_tpu.cli import infer as jinfer
from octcubem_tpu.compat.torch_export import (export_state_dict,
                                              save_torch_checkpoint)
from octcubem_tpu.models import coem as jcoem
from octcubem_tpu.models import vit_st as jvit
from octcubem_tpu.utils import saliency as jsal
from octcubem_tpu_torch.cli import infer as tinfer
from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.models import coem as tcoem
from octcubem_tpu_torch.models import vit_st as tvit
from octcubem_tpu_torch.ops import _cuda
from octcubem_tpu_torch.utils import saliency as tsal

KW = dict(num_frames=12, t_patch_size=3, img_size=32, patch_size=16,
          in_chans=1, num_classes=6, embed_dim=64, depth=2, num_heads=2,
          head_type="dropout", global_pool=True)
GRID = (4, 2, 2)
# the COEM pair (clip_pair_gradcam): the same OCT tower, a 48 x 48 en face
# tower (9 patches + cls)
COEM_KW = dict(embed_dim=16, vision_cfg=dict(
    num_frames=12, t_patch_size=3, img_size=32, patch_size=16, in_chans=1,
    embed_dim=64, depth=2, num_heads=2), enface_cfg=dict(
    img_size=48, patch_size=16, in_chans=3, embed_dim=64, depth=2,
    num_heads=2, num_mod_head=1))
TOL_CAM = 1e-4


@pytest.fixture(autouse=True)
def _restore_jax_precision():
    """The JAX CLIs set the global matmul precision; put it back."""
    before = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", before)


@functools.lru_cache(maxsize=None)
def _jax_model_params():
    jm = jvit.VisionTransformerST(**KW, capture_cam=True, attn_impl="flash")
    x = jnp.zeros((2, 12, 32, 32, 1), jnp.float32)
    variables = jax.jit(jm.init)(jax.random.key(0), x)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"])
    return jm, {"params": params,
                "perturbations": variables["perturbations"]}


def _port_model(params, **kw):
    m = tvit.VisionTransformerST(**dict(KW, **kw), capture_cam=True)
    m.load_state_dict(state_dict_from_jax(params), strict=True)
    return m.eval()


def _volume(seed=3):
    return np.random.default_rng(seed).standard_normal(
        (2, 12, 32, 32, 1)).astype(np.float32)


@pytest.mark.parametrize("layer,class_idx", [(-1, None), (-1, 3), (0, None),
                                             (0, 5)])
def test_gradcam_matches_jax(layer, class_idx):
    jm, variables = _jax_model_params()
    x = _volume()
    ref = jsal.gradcam(jm, variables, jnp.asarray(x), class_idx=class_idx,
                       layer=layer, grid=GRID)
    model = _port_model(variables["params"])
    for p in model.parameters():  # frozen, as when serving
        p.requires_grad_(False)
    got = tsal.gradcam(model, torch.from_numpy(x), class_idx=class_idx,
                       layer=layer, grid=GRID)
    assert got.shape == ref.shape == (2,) + GRID
    assert np.isfinite(got).all() and got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL_CAM, rtol=0)
    assert model.blocks.cam == []  # released after the map


def test_gradcam_runs_the_kernels_path_and_keeps_logits():
    """capture_cam adds zeros: the logits equal the plain model's; the map
    at layer 0 differentiates block 1 only (its attention backward), and
    no kernel runs on the CPU."""
    _, variables = _jax_model_params()
    x = torch.from_numpy(_volume())
    model = _port_model(variables["params"])
    plain = tvit.VisionTransformerST(**KW)
    plain.load_state_dict(state_dict_from_jax(variables["params"]))
    with torch.inference_mode():
        assert torch.equal(model(x), plain.eval()(x))
    with torch.enable_grad():
        model(x)
    assert len(model.blocks.cam) == 2
    assert all(p is not None and p.requires_grad for _, p in model.blocks.cam)
    _cuda.reset_launches()
    tsal.gradcam(model, x, layer=0, grid=GRID)
    assert not any(_cuda.launches.values())


def test_gradcam_needs_capture_cam():
    """Both maps refuse a model built without capture_cam: the port with
    ValueError; the JAX clip_pair_gradcam finds no perturbations."""
    with pytest.raises(ValueError, match="capture_cam=True"):
        tsal.gradcam(tvit.VisionTransformerST(**KW), torch.zeros(
            (1, 12, 32, 32, 1)))
    img, enf = (np.zeros((1,) + s, np.float32) for s in (
        (12, 32, 32, 1), (48, 48, 3)))
    with pytest.raises(ValueError, match="capture_cam=True"):
        tsal.clip_pair_gradcam(tcoem.COEP2Tower(**COEM_KW),
                               torch.from_numpy(img), torch.from_numpy(enf))
    jm = jcoem.COEP2Tower(**COEM_KW, attn_impl="naive")
    shapes = jax.eval_shape(jm.init, jax.random.key(0), img, enf)
    assert "perturbations" not in shapes
    with pytest.raises(KeyError, match="perturbations"):
        jsal.clip_pair_gradcam(jm, {"params": shapes["params"]}, img, enf)


@functools.lru_cache(maxsize=None)
def _coem_pair():
    jm = jcoem.COEP2Tower(**COEM_KW, capture_cam=True, attn_impl="flash")
    rng = np.random.default_rng(8)
    img = rng.random((2, 12, 32, 32, 1), np.float32)
    enf = rng.random((2, 48, 48, 3), np.float32)
    variables = jax.jit(jm.init)(jax.random.key(0), img, enf)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"])
    tm = tcoem.create_model(tcoem.COEP2Tower, device="cpu", capture_cam=True,
                            **COEM_KW)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, {"params": params,
                "perturbations": variables["perturbations"]}, tm, img, enf


@pytest.mark.parametrize("target,layer,grid", [
    ("image", -1, GRID), ("image", 0, GRID), ("enface", -1, (3, 3)),
    ("enface", 0, None)])
def test_clip_pair_gradcam_matches_jax(target, layer, grid):
    """|dSim/dA| over the channels of one tower's block, the same map as
    the JAX package's (its Pallas kernels in interpret mode)."""
    jm, variables, tm, img, enf = _coem_pair()
    want = jsal.clip_pair_gradcam(jm, variables, jnp.asarray(img),
                                  jnp.asarray(enf), target=target,
                                  layer=layer, grid=grid)
    got = tsal.clip_pair_gradcam(tm, torch.from_numpy(img),
                                 torch.from_numpy(enf), target=target,
                                 layer=layer, grid=grid)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, want, atol=TOL_CAM)
    assert not tm.visual.trunk.blocks.cam and not tm.enface.trunk.blocks.cam


@pytest.fixture
def small_vit_l(monkeypatch):
    """Both infer CLIs build ``flash_attn_vit_large_patch16``: cut to the
    test width."""
    narrow = dict(embed_dim=64, depth=2)
    monkeypatch.setattr(jvit, "flash_attn_vit_large_patch16",
                        functools.partial(jvit.VisionTransformerST, **narrow))
    monkeypatch.setattr(tvit, "flash_attn_vit_large_patch16",
                        functools.partial(tvit.VisionTransformerST, **narrow))


def test_infer_saliency_dir_matches_jax(tmp_path, small_vit_l, capsys):
    """infer --saliency_dir on one checkpoint and volume: the same
    probabilities and top disease as the JAX CLI, and the overlay PNG
    written under the same name."""
    _, variables = _jax_model_params()
    path = str(tmp_path / "cls.pth")
    save_torch_checkpoint(path, export_state_dict(
        {"params": variables["params"]}, style="flash"))
    vol = (np.random.default_rng(4).random((14, 40, 40)) * 255
           ).astype(np.float32)
    vpath = str(tmp_path / "vol.npy")
    np.save(vpath, vol)
    common = [vpath, "--ckpt", path, "--num_frames", "12", "--input_size",
              "32", "--nb_classes", "6", "--num_heads", "2"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jprobs = jinfer.main(common + ["--saliency_dir", jdir])
    jout = capsys.readouterr().out
    tprobs = tinfer.main(common + ["--saliency_dir", tdir, "--device", "cpu"])
    tout = capsys.readouterr().out
    np.testing.assert_allclose(tprobs, jprobs, atol=1e-5)
    assert np.argmax(tprobs[:, 1]) == np.argmax(jprobs[:, 1])
    jpng = [s.split(": ", 1)[1] for s in jout.splitlines()
            if s.startswith("saliency overlay:")]
    tpng = [s.split(": ", 1)[1] for s in tout.splitlines()
            if s.startswith("saliency overlay:")]
    assert len(jpng) == len(tpng) == 1
    assert os.path.basename(tpng[0]) == os.path.basename(jpng[0])
    assert os.path.getsize(tpng[0]) > 1000 and tpng[0].startswith(tdir)
