"""Port parity: the 2D pieces (ops/pos_embed.py, resize_volume_trilinear,
PatchEmbed2D) and the 2D MAE (models/mae2d.py) against the JAX package on
the CPU.

The sincos tables are numpy on both sides, equal to the bit; the
interpolations and embeddings are fp32 matrix products in another
summation order (1e-6).  The MAE runs the JAX module's own masking noise
(drawn with its "masking" rng) on the same weights (state_dict_from_jax;
its pos tables are constants, in no state dict); the JAX side runs
attn_impl="flash" (the Pallas kernels in interpret mode), the port B1 /
B2's plain versions.  Tiny MAE: width 64, 2 heads of 32, 2 + 2 blocks,
64 x 64 (16 patches; mask 0.75 keeps 4: encoder 5 tokens, decoder 17).
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from octcubem_tpu.models import mae2d as jmae2d
from octcubem_tpu.nn import patch_embed as jpe
from octcubem_tpu.ops import pos_embed as jpos
from octcubem_tpu.ops import resize as jresize
from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.models import mae2d as tmae2d
from octcubem_tpu_torch.nn import patch_embed as tpe
from octcubem_tpu_torch.ops import pos_embed as tpos
from octcubem_tpu_torch.ops import resize as tresize

KW = dict(img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=2,
          decoder_embed_dim=64, decoder_depth=2, decoder_num_heads=2)
# the JAX package's full-model fp32 tolerance (tests/test_torch_parity.py)
TOL_OUT = dict(atol=1e-5, rtol=1e-5)
# per leaf |port - jax| <= 5e-4 max|jax| (tests/test_flash_attention.py)
GRAD_REL = 5e-4
TOL_MATMUL = dict(atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------ pos embeds

@pytest.mark.parametrize("dim,grid,cls", [(64, 4, True), (1024, 14, True),
                                          (512, 14, False), (96, 7, True)])
def test_sincos_tables_equal_jax(dim, grid, cls):
    got = tpos.sincos_2d(dim, grid, cls_token=cls)
    ref = jpos.sincos_2d(dim, grid, cls_token=cls)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    pos = np.arange(11, dtype=np.float32) * 0.5
    np.testing.assert_array_equal(tpos.sincos_1d(dim, pos),
                                  jpos.sincos_1d(dim, pos))


@pytest.mark.parametrize("old,new,extra", [((4, 4), (7, 7), 1),
                                           ((14, 14), (16, 16), 0),
                                           ((8, 8), (8, 8), 1)])
def test_interpolate_spatial_matches_jax(old, new, extra):
    x = np.random.default_rng(0).standard_normal(
        (1, extra + old[0] * old[1], 24)).astype(np.float32)
    ref = np.asarray(jpos.interpolate_spatial_pos_embed(
        jnp.asarray(x), old, new, extra))
    got = tpos.interpolate_spatial_pos_embed(torch.from_numpy(x), old, new,
                                             extra).numpy()
    np.testing.assert_allclose(got, ref, **TOL_MATMUL)


@pytest.mark.parametrize("new,kind", [(24, "interp"), (10, "interp"),
                                      (10, "crop"), (16, "crop")])
def test_interpolate_temporal_matches_jax(new, kind):
    x = np.random.default_rng(1).standard_normal((1, 16, 8)).astype(
        np.float32)
    ref = np.asarray(jpos.interpolate_temporal_pos_embed(jnp.asarray(x), new,
                                                         kind))
    got = tpos.interpolate_temporal_pos_embed(torch.from_numpy(x), new,
                                              kind).numpy()
    np.testing.assert_allclose(got, ref, **TOL_MATMUL)


@pytest.mark.parametrize("stored,use_temporal,cls", [(8, True, True),
                                                     (4, True, False),
                                                     (8, False, True)])
def test_build_sep_pos_embed_matches_jax(stored, use_temporal, cls):
    rng = np.random.default_rng(2)
    spat = rng.standard_normal((1, stored * stored, 16)).astype(np.float32)
    temp = rng.standard_normal((1, 3, 16)).astype(np.float32)
    pc = rng.standard_normal((1, 1, 16)).astype(np.float32) if cls else None
    ref = np.asarray(jpos.build_sep_pos_embed(
        jnp.asarray(spat), jnp.asarray(temp), (stored, stored), (4, 4), 3,
        None if pc is None else jnp.asarray(pc), use_temporal))
    got = tpos.build_sep_pos_embed(
        torch.from_numpy(spat), torch.from_numpy(temp), (stored, stored),
        (4, 4), 3, None if pc is None else torch.from_numpy(pc),
        use_temporal).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL_MATMUL)


# ------------------------------------------------- resize, patch embed

@pytest.mark.parametrize("shape,out", [((2, 10, 40, 36), (6, 32, 32)),
                                       ((7, 20, 33), (48, 64, 64)),
                                       ((3, 8, 8), (3, 8, 8))])
def test_resize_volume_trilinear_matches_jax(shape, out):
    x = np.random.default_rng(3).random(shape).astype(np.float32) * 255
    ref = np.asarray(jresize.resize_volume_trilinear(jnp.asarray(x), out))
    got = tresize.resize_volume_trilinear(torch.from_numpy(x), out).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6 * 255, rtol=1e-6)


@pytest.mark.parametrize("chans", [1, 3])
def test_patch_embed_2d_matches_jax(chans):
    """Each output is a dot of p*p*C = 256 or 768 fp32 products, summed in
    another order on each side: held to 1e-6 of the sum of the products'
    magnitudes (the dot's own rounding scale; measured up to 1.5e-6 of the
    output itself at 768 terms)."""
    jm = jpe.PatchEmbed2D(64, 16, chans, 48)
    x = np.random.default_rng(4).standard_normal(
        (2, 64, 64, chans)).astype(np.float32)
    params = _perturb(jm.init(jax.random.key(0), jnp.asarray(x)), 0)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = tpe.PatchEmbed2D(64, 16, chans, 48)
    sd = {k.removeprefix("patch_embed."): v for k, v in
          state_dict_from_jax({"patch_embed": params["params"]}).items()}
    tm.load_state_dict(sd, strict=True)
    assert tm.proj.weight.shape == (48, chans, 16, 16)
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == (2, 16, 48)
    mag = np.abs(np.asarray(jm.apply(jax.tree_util.tree_map(
        np.abs, params), jnp.asarray(np.abs(x)))))
    assert (np.abs(got - ref) <= 1e-6 * mag).all()


# ------------------------------------------------------------- the MAE

def _perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


@functools.lru_cache(maxsize=None)
def _jax_setup(chans, norm_pix):
    jm = jmae2d.MaskedAutoencoderViT2D(**KW, in_chans=chans,
                                       norm_pix_loss=norm_pix,
                                       attn_impl="flash")
    x = np.random.default_rng(5).standard_normal(
        (2, 64, 64, chans)).astype(np.float32)
    params = jax.jit(functools.partial(jm.init, mask_ratio=0.75))(
        {"params": jax.random.key(0), "masking": jax.random.key(0)},
        jnp.asarray(x))
    params = _perturb(params, 1)
    key = jax.random.key(9)
    noise = np.array(jm.apply(
        params, method=lambda m: jax.random.uniform(m.make_rng("masking"),
                                                    (2, 16)),
        rngs={"masking": key}))
    return jm, params, x, key, noise


def _jax_loss_and_grads(jm, params, x, key):
    def f(p):
        loss, per_image, pred, mask = jm.apply(p, jnp.asarray(x), 0.75,
                                               rngs={"masking": key})
        return loss, (per_image, pred, mask)

    (loss, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    return loss, aux, grads


def _port(params, chans, norm_pix):
    m = tmae2d.MaskedAutoencoderViT2D(**KW, in_chans=chans,
                                      norm_pix_loss=norm_pix)
    m.load_state_dict(state_dict_from_jax(params), strict=True)
    return m


def test_mae2d_pos_tables_are_constants():
    m = tmae2d.create_model(tmae2d.mae_vit_base_patch16, device="cpu",
                            img_size=64, depth=1, decoder_depth=1)
    assert "pos_embed" not in m.state_dict()
    np.testing.assert_array_equal(m.pos_embed[0].numpy(),
                                  jpos.sincos_2d(768, 4, cls_token=True))
    np.testing.assert_array_equal(m.decoder_pos_embed[0].numpy(),
                                  jpos.sincos_2d(512, 4, cls_token=True))
    assert m.training


@pytest.mark.parametrize("chans,norm_pix", [(1, False), (3, True)])
def test_mae2d_forward_and_grads_match_jax(chans, norm_pix):
    """loss, per-image loss, pred and mask within 1e-5 from the same
    noise; per-leaf gradients within GRAD_REL."""
    jm, params, x, key, noise = _jax_setup(chans, norm_pix)
    loss, (per_image, pred, mask), grads = _jax_loss_and_grads(jm, params, x,
                                                               key)
    model = _port(params, chans, norm_pix)
    out = model(torch.from_numpy(x), 0.75, noise=torch.from_numpy(noise))
    out[0].backward()
    got_loss, got_img, got_pred, got_mask = (t.detach().numpy() for t in out)
    np.testing.assert_array_equal(got_mask, np.asarray(mask))
    assert got_pred.shape == (2, 16, 16 * 16 * chans)
    np.testing.assert_allclose(got_loss, np.asarray(loss), **TOL_OUT)
    np.testing.assert_allclose(got_img, np.asarray(per_image), **TOL_OUT)
    np.testing.assert_allclose(got_pred, np.asarray(pred), **TOL_OUT)
    ref_grads = state_dict_from_jax(grads)
    for name, p in model.named_parameters():
        ref = ref_grads[name].numpy()
        tol = GRAD_REL * max(np.abs(ref).max(), 1e-8)
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=tol, rtol=0,
                                   err_msg=name)


def test_mae2d_unmasked_and_patchify_match_jax():
    """mask_ratio 0 needs no noise (every patch kept, the loss 0 over no
    masked patch); patchify / unpatchify are the JAX module's."""
    jm, params, x, key, _ = _jax_setup(3, True)
    model = _port(params, 3, True)
    with torch.no_grad():
        loss, per_image, pred, mask = model(torch.from_numpy(x), 0.0)
    assert float(mask.sum()) == 0.0 and float(loss) == 0.0
    ref = jm.apply(params, jnp.asarray(x), method=jm.patchify)
    got = model.patchify(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(model.unpatchify(got).numpy(), x)
    with pytest.raises(ValueError, match="noise"):
        model(torch.from_numpy(x), 0.75)
