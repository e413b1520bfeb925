"""Port parity: the MAE pretrainer's ops and model against the JAX package.

Masking takes the JAX module's own noise (drawn with its "masking" rng),
so the two masks are equal; the model runs both B1/B2 branches on both
stacks at two small geometries (widths 128, 2 encoder + 1 decoder
blocks, ``high_res_input_size`` twice ``input_size``):
  (a) 64x64 x 24 frames, mask 0.90: L = 128, 12 kept, encoder 13 tokens
      (no cls fold), decoder 129 (cls fold);
  (b) 128x128 x 24 frames, mask 0.75: encoder 129, decoder 513.
The JAX side runs attn_impl="flash" (the packed Pallas kernels in
interpret mode); the port runs its default path, the plain B1/B2 on the
CPU.  fp32 tolerances, each stated where it is used.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from octcubem_tpu.models import mae3d as jmae
from octcubem_tpu.ops import masking as jmask
from octcubem_tpu.ops import patchify as jpatch
from octcubem_tpu.ops import resize as jresize
from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.models import mae3d as tmae
from octcubem_tpu_torch.ops import flash_attention as tfa
from octcubem_tpu_torch.ops import masking as tmask
from octcubem_tpu_torch.ops import patchify as tpatch
from octcubem_tpu_torch.ops import resize as tresize

GEOM = {
    "a": dict(input_size=64, high_res_input_size=128, mask_ratio=0.90),
    "b": dict(input_size=128, high_res_input_size=256, mask_ratio=0.75),
}
BASE = dict(patch_size=16, in_chans=1, embed_dim=128, depth=2, num_heads=2,
            decoder_embed_dim=128, decoder_depth=1, num_frames=24,
            t_patch_size=3)
# the loss and pred: sums over ~1e5 fp32 terms through 3 blocks; the
# JAX package's own full-model fp32 tolerance (tests/test_torch_parity.py)
TOL_OUT = dict(atol=1e-5, rtol=1e-5)
# gradients: 5e-4 of the leaf's largest entry (the kernel-gradient
# tolerance, tests/test_flash_attention.py), as a relative error
GRAD_REL = 5e-4


def model_kw(geom, dec_heads=4, **kw):
    g = GEOM[geom]
    return dict(BASE, input_size=g["input_size"],
                high_res_input_size=g["high_res_input_size"],
                decoder_num_heads=dec_heads, pred_t_dim=24, **kw)


def perturb(params, seed):
    """Init values plus noise, so zero biases, unit LN scales and zero
    tokens all carry signal."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


def jax_init(kw, x, mask_ratio, seed=0):
    model = jmae.MaskedAutoencoderViT3D(**kw, attn_impl="flash")
    params = model.init({"params": jax.random.key(seed),
                         "masking": jax.random.key(seed)}, jnp.asarray(x),
                        mask_ratio=mask_ratio)
    return model, perturb(params, seed + 1)


def jax_noise(model, params, x, key):
    """The noise the JAX module draws for x with rngs={"masking": key}."""
    b, L = x.shape[0], (x.shape[1] // model.t_patch_size) * (
        x.shape[2] // model.patch_size) ** 2
    return np.array(model.apply(
        params, jnp.asarray(x),
        method=lambda m, x: jax.random.uniform(m.make_rng("masking"), (b, L)),
        rngs={"masking": key}))


def torch_model(kw, params):
    m = tmae.MaskedAutoencoderViT3D(**kw)
    m.load_state_dict(state_dict_from_jax(params), strict=True)
    return m


def volume(geom, b=2, frames=24, seed=5, high_res=False):
    size = GEOM[geom]["high_res_input_size" if high_res else "input_size"]
    return np.random.default_rng(seed).standard_normal(
        (b, frames, size, size, 1)).astype(np.float32)


def assert_grads_close(sd_grads, model, rel=GRAD_REL):
    """Per leaf: |port - jax| <= rel * max|jax| (+ a floor for all-zero
    leaves)."""
    for name, p in model.named_parameters():
        ref = sd_grads[name].numpy()
        got = (p.grad.numpy() if p.grad is not None
               else np.zeros_like(ref))
        tol = rel * max(np.abs(ref).max(), 1e-8)
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0, err_msg=name)


# ------------------------------------------------------------- masking

@pytest.mark.parametrize("ratio,pre", [(0.9, False), (0.75, True),
                                       (0.0, False)])
def test_random_masking_matches_jax(ratio, pre):
    key = jax.random.key(3)
    b, L = 3, 128
    ref = jmask.random_masking(key, b, L, ratio, pre_mask=(
        jnp.asarray(np.random.default_rng(1).random((b, L)) > 0.8)
        if pre else None))
    noise = np.array(jax.random.uniform(key, (b, L)))
    pm = (torch.from_numpy(np.random.default_rng(1).random((b, L)) > 0.8)
          if pre else None)
    got = tmask.random_masking(torch.from_numpy(noise), L, ratio, pre_mask=pm)
    for a, r in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_vitl_keeps_511_tokens():
    """int(5120 * (1 - 0.9)) is 511 in Python floats, so the ViT-L
    encoder sees 511 + cls = 512 tokens (no cls fold in B1/B2) and the
    decoder 5,120 + cls = 5,121 (cls fold) -- as in the JAX package."""
    L = (60 // 3) * (256 // 16) ** 2
    assert L == 5120 and tmask.keep_count(L, 0.90) == 511
    noise = torch.rand((1, L), generator=torch.Generator().manual_seed(0))
    mk = tmask.random_masking(noise, L, 0.90)
    assert mk.ids_keep.shape == (1, 511) and int(mk.mask.sum()) == 5120 - 511
    ref = jmask.random_masking(jax.random.key(0), 1, L, 0.90)
    assert ref.ids_keep.shape == (1, 511)
    assert not tfa._cls_split(511 + 1) and tfa._cls_split(L + 1)


def test_gather_and_permute_tokens():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 10, 4)).astype(np.float32)
    perm = np.stack([rng.permutation(10) for _ in range(2)])
    inv = np.argsort(perm, axis=1)
    xt, pt, it = map(torch.from_numpy, (x, perm, inv))
    np.testing.assert_array_equal(
        tmask.permute_tokens(xt, pt, it).numpy(),
        np.asarray(jmask.permute_tokens(jnp.asarray(x), jnp.asarray(perm),
                                        jnp.asarray(inv))))
    keep = pt[:, :4]
    np.testing.assert_array_equal(
        tmask.gather_keep_tokens(xt, keep, it).numpy(),
        np.asarray(jmask.gather_keep_tokens(jnp.asarray(x), jnp.asarray(perm[:, :4]),
                                            jnp.asarray(inv))))


# ----------------------------------------------------- patchify, resize

def test_patchify_and_tube_embed_tokens_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 32, 48, 2)).astype(np.float32)
    ref = np.asarray(jpatch.patchify_3d(jnp.asarray(x), 3, 16))
    got = tpatch.patchify_3d(torch.from_numpy(x), 3, 16)
    np.testing.assert_array_equal(got.numpy(), ref)
    back = tpatch.unpatchify_3d(got, 3, 16, (2, 2, 3), 2)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jpatch.unpatchify_3d(jnp.asarray(ref), 3, 16,
                                                      (2, 2, 3), 2)))
    kernel = rng.standard_normal((3, 16, 16, 2, 8)).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    ref_e = np.asarray(jpatch.tube_embed_tokens(jnp.asarray(ref),
                                                jnp.asarray(kernel),
                                                jnp.asarray(bias)))
    weight = torch.from_numpy(kernel.transpose(4, 3, 0, 1, 2).copy())
    got_e = tpatch.tube_embed_tokens(got, weight, torch.from_numpy(bias))
    # sums of 1,536 unit-scale fp32 terms in another order: ~1e-4 absolute
    tol = dict(atol=2e-4, rtol=1e-5)
    np.testing.assert_allclose(got_e.numpy(), ref_e, **tol)
    # the same rows as the full tube embedding
    full = tpatch.tube_embed(torch.from_numpy(x), weight,
                             torch.from_numpy(bias), 3, 16)
    np.testing.assert_allclose(full.reshape(2, -1, 8).numpy(), got_e.numpy(),
                               **tol)


@pytest.mark.parametrize("hw,out", [((8, 8), (4, 4)), ((32, 32), (16, 16)),
                                    ((5, 7), (9, 3))])
def test_resize_grid_bicubic_matches_jax_and_torch(hw, out):
    x = np.random.default_rng(6).standard_normal((1, *hw, 3)).astype(np.float32)
    ref = np.asarray(jresize.resize_grid_bicubic(jnp.asarray(x), out))
    got = tresize.resize_grid_bicubic(torch.from_numpy(x), out).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    torch_ref = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=out, mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, torch_ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("t,out", [(8, 20), (20, 8), (5, 5)])
def test_resize_seq_linear_matches_jax(t, out):
    x = np.random.default_rng(7).standard_normal((2, t, 4)).astype(np.float32)
    ref = np.asarray(jresize.resize_seq_linear(jnp.asarray(x), out))
    got = tresize.resize_seq_linear(torch.from_numpy(x), out).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(
        tresize._interp_matrix_1d(t, out, "linear"),
        jresize._interp_matrix_1d(t, out, "linear"))


def test_cached_constants_first_made_under_inference_mode():
    """The interpolation matrices and the loss's frame index are made on
    the device once and reused; made first under inference_mode (a
    serving forward), they still serve a forward whose backward saves
    them."""
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 11, 11, 2)).astype(np.float32))
    with torch.inference_mode():
        tresize.resize_grid_bicubic(x, (6, 6))
        idx = tmae._frame_index(13, 7, x.device)
    assert tmae._frame_index(13, 7, x.device) is idx
    np.testing.assert_array_equal(
        idx.numpy(), np.linspace(0, 12, 7).astype(np.int64))
    assert tresize._matrix(11, 6, "cubic", x) is tresize._matrix(11, 6,
                                                                 "cubic", x)
    xg = x.clone().requires_grad_()
    tresize.resize_grid_bicubic(xg, (6, 6)).sum().backward()
    ref = x.clone().requires_grad_()
    torch.nn.functional.interpolate(
        ref.permute(0, 3, 1, 2), size=(6, 6), mode="bicubic",
        align_corners=False).sum().backward()
    np.testing.assert_allclose(xg.grad.numpy(), ref.grad.numpy(), atol=1e-5)


# ---------------------------------------------------------------- model

# (geometry, decoder heads, extra model kwargs, 2D high-res input)
MODEL_CASES = [
    ("a", 4, {}, False),
    ("a", 1, dict(norm_pix_loss=True, pred_t_dim=8), False),
    ("a", 4, {}, True),
    ("b", 4, {}, False),
]


@pytest.mark.parametrize("geom,dec_heads,extra,two_d", MODEL_CASES)
def test_mae_forward_and_grad_match_jax(geom, dec_heads, extra, two_d):
    """(loss, frame_losses, pred, mask) and d loss / d params per leaf.
    two_d: a 3-frame input at the high-res size (one temporal tube: no
    temporal pos term, the high-res patch embed, no frame subsampling)."""
    kw = model_kw(geom, dec_heads)
    kw.update(extra)
    ratio = GEOM[geom]["mask_ratio"]
    x = volume(geom, frames=3 if two_d else 24, high_res=two_d)
    jm, params = jax_init(kw, volume(geom), ratio)
    key = jax.random.key(11)
    noise = jax_noise(jm, params, x, key)

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x), mask_ratio=ratio,
                       rngs={"masking": key})
        return out[0], out
    (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    tm = torch_model(kw, params)
    out = tm(torch.from_numpy(x), ratio, torch.from_numpy(noise))
    out[0].backward()
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    for name, got, r in zip(("loss", "frame_losses", "pred"), out[:3], ref[:3]):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(r),
                                   **TOL_OUT, err_msg=name)
    assert_grads_close(state_dict_from_jax(jgrads), tm)


def test_mae_bf16_forward_matches_jax():
    """bf16 compute: both sides round at every Dense and residual add but
    in different places; the loss agrees to 1e-2 relative (measured
    ~2e-3 on this geometry)."""
    kw = model_kw("a")
    x = volume("a")
    jm, params = jax_init(kw, x, 0.9)
    jm16 = jmae.MaskedAutoencoderViT3D(**kw, attn_impl="flash",
                                       dtype=jnp.bfloat16)
    key = jax.random.key(12)
    noise = jax_noise(jm, params, x, key)
    ref = jm16.apply(params, jnp.asarray(x), mask_ratio=0.9,
                     rngs={"masking": key})
    tm = torch_model(dict(kw, dtype=torch.bfloat16), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), 0.9, torch.from_numpy(noise))
    assert out[2].dtype == torch.bfloat16
    np.testing.assert_allclose(out[0].item(), float(ref[0]), rtol=1e-2)


def test_forward_patch_embed_and_eval_branch_match_jax():
    kw = model_kw("a")
    x = volume("a")
    jm, params = jax_init(kw, x, 0.9)
    tm = torch_model(kw, params)
    with torch.no_grad():
        pe = tm.forward_patch_embed(torch.from_numpy(x)).numpy()
        loss0 = tm(torch.from_numpy(x), 0.0)[0].item()  # no noise needed
    np.testing.assert_allclose(
        pe, np.asarray(jm.apply(params, jnp.asarray(x),
                                method=jm.forward_patch_embed)),
        atol=1e-5, rtol=1e-5)
    ref0 = jm.apply(params, jnp.asarray(x), mask_ratio=0.0)[0]
    assert loss0 == float(ref0) == 0.0  # nothing masked: no loss terms


def test_state_dict_from_jax_loads_mae_strict():
    kw = model_kw("a")
    _, params = jax_init(kw, volume("a"), 0.9)
    sd = state_dict_from_jax(params)
    tm = tmae.MaskedAutoencoderViT3D(**kw)
    assert set(sd) == set(tm.state_dict())
    assert "high_res_patch_embed.proj.weight" in sd and "mask_token" in sd
    # remat and remat_norm keep the parameter names (their gradients:
    # test_torch_port_remat.py)
    for flags in (dict(remat=True), dict(remat_norm=True)):
        assert set(tmae.MaskedAutoencoderViT3D(**kw, **flags).state_dict()
                   ) == set(sd)
