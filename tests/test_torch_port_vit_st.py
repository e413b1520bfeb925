"""Port parity: octcubem_tpu_torch's ViT-ST and its blocks against the JAX
package, weights carried by compat.jax_params.state_dict_from_jax.

The JAX side runs attn_impl="flash" (the packed Pallas kernel in
interpret mode); the port runs its default path, B1's plain version on
the CPU.  Tiny model: embed 128, 2 heads (head_dim 64), depth 2, input
6x128x128 -> 2*8*8 tube tokens + cls = 129 (a cls-prefixed n, as at
ViT-L scale).  fp32 at 5e-5.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from octcubem_tpu.models import vit_st as jvit
from octcubem_tpu.nn import layers as jlayers
from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.models import vit_st as tvit
from octcubem_tpu_torch.nn import layers as tlayers

KW = dict(num_frames=6, t_patch_size=3, img_size=128, patch_size=16,
          in_chans=1, num_classes=4, embed_dim=128, depth=2, num_heads=2)
# bf16: both sides round activations to bf16 at every Dense and residual
# add, but in different places (fused bias add, GELU internals); measured
# max |dlogits| 2.7e-3 (dropout head) and 3.9e-3 (aggregate head) on
# logits of magnitude <= 1.2, about one bf16 step at that magnitude
BF16_ATOL = 2e-2


def _perturb(params, seed):
    """Init values plus noise, so zero biases, unit LN scales and the zero
    cls token all carry signal."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


@pytest.fixture(scope="module", params=["dropout", "aggregate"])
def jax_params(request):
    head_type = request.param
    # the param tree does not depend on attn_impl; init on the naive path
    model = jvit.VisionTransformerST(**KW, head_type=head_type,
                                     attn_impl="naive")
    x0 = jnp.zeros((1, 6, 128, 128, 1), jnp.float32)
    params = jax.jit(model.init)(jax.random.key(0), x0)
    return head_type, _perturb(params, seed=len(head_type))


@pytest.fixture(scope="module")
def volume():
    return np.random.default_rng(7).standard_normal(
        (2, 6, 128, 128, 1)).astype(np.float32)


def _forward_both(head_type, params, x, global_pool, parity, jdtype, tdtype):
    jm = jvit.VisionTransformerST(**KW, head_type=head_type,
                                  global_pool=global_pool, parity=parity,
                                  dtype=jdtype, attn_impl="flash")
    ref = np.asarray(jm.apply(params, jnp.asarray(x)), np.float32)
    tm = tvit.VisionTransformerST(**KW, head_type=head_type,
                                  global_pool=global_pool, parity=parity,
                                  dtype=tdtype)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        out = tm.eval()(torch.from_numpy(x)).float().numpy()
    return out, ref


@pytest.mark.parametrize("global_pool,parity",
                         [(True, "flash"), (False, "standard")])
def test_vit_st_fp32_matches_jax(jax_params, volume, global_pool, parity):
    head_type, params = jax_params
    out, ref = _forward_both(head_type, params, volume, global_pool, parity,
                             jnp.float32, torch.float32)
    assert out.shape == (2, 4)
    np.testing.assert_allclose(out, ref, atol=5e-5, rtol=5e-5)


def test_vit_st_bf16_matches_jax(jax_params, volume):
    head_type, params = jax_params
    out, ref = _forward_both(head_type, params, volume, True, "flash",
                             jnp.bfloat16, torch.bfloat16)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("high_res_input", [False, True])
def test_vit_st_high_res_pos_embed_matches_jax(high_res_input):
    """high_res_input_size = 2 x img_size: the pos embeds are stored at the
    256 grid; a 128-pixel input pools them bicubically to its grid, a
    256-pixel input takes the high-res patch embed (2*16*16 tokens + cls).
    fp32 at 5e-5."""
    kw = dict(KW, head_type="dropout", high_res_input_size=256)
    jm = jvit.VisionTransformerST(**kw, attn_impl="naive")
    size = 256 if high_res_input else 128
    x = np.random.default_rng(9).standard_normal(
        (1, 6, size, size, 1)).astype(np.float32)
    params = _perturb(jax.jit(jm.init)(jax.random.key(3), jnp.asarray(x)), 5)
    jm = jvit.VisionTransformerST(**kw, attn_impl="flash")
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = tvit.VisionTransformerST(**kw)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    assert tm.pos_embed_spatial.shape == (1, 256, 128)
    with torch.inference_mode():
        out = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-5, rtol=5e-5)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(8).standard_normal(
        (2, 129, 128)).astype(np.float32)


def test_mha_matches_jax(tokens):
    jm = jlayers.MHA(128, 2, attn_impl="flash")
    params = _perturb(jm.init(jax.random.key(1), jnp.asarray(tokens)), 3)
    ref = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    tm = tlayers.MHA(128, 2)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        out = tm(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-5, rtol=5e-5)


def test_block_matches_jax(tokens):
    jm = jlayers.Block(128, 2, attn_impl="flash")
    params = _perturb(jm.init(jax.random.key(2), jnp.asarray(tokens)), 4)
    ref_h, ref_m = jm.apply(params, jnp.asarray(tokens))
    tm = tlayers.Block(128, 2)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        h, m = tm.eval()(torch.from_numpy(tokens))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=5e-5,
                               rtol=5e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), atol=5e-5,
                               rtol=5e-5)


def test_drop_path_only_in_training():
    """DropPath is the identity in eval mode; in training it keeps or
    zeroes whole samples, drawing from the generator it is given."""
    dp = tlayers.DropPath(0.5)
    x = torch.ones(64, 3, 4)
    assert dp.eval()(x) is x
    dp.train()
    a = dp(x, torch.Generator().manual_seed(0))
    b = dp(x, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    per_sample = a.reshape(64, -1)
    assert set(per_sample.unique().tolist()) <= {0.0, 2.0}
    assert (per_sample == per_sample[:, :1]).all()
