"""Port parity: the ViT-H/14 family at its reference head_dim of 80 against
the JAX package, narrow.

At head_dim 80 the packed kernels B1 / B2 serve nothing, so both packages
take their [B, H, N, D] path: the JAX package falls back from its packed
path (128 % 80 != 0) and runs its Pallas kernels B3-B5 and B7 in
interpret mode; the port reroutes to ``flash_attention`` and runs the
plain versions of the same kernels.  Weights cross by
``state_dict_from_jax`` from JAX params built with ``attn_impl="flash"``.

- the classifier: patch 14, 2 blocks, 160 wide with 2 heads of 80,
  6 x 112 x 112 -> 2 x 8 x 8 tube tokens + cls = 129 (B3 forward, B4
  backward), pos embeds stored at the 224 grid and pooled to 112;
- the MAE: encoder and decoder 160 wide with 2 heads of 80, 6 x 112 x 112,
  mask 0.90: L = 128, 12 kept, the encoder sees 13 tokens (B5 / B7) and
  the cls-prefixed decoder 129 (B3 / B4): loss, per-leaf gradients, and
  one train step against one JAX step with the JAX step's noise.

fp32 tolerances, each stated where it is used.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from octcubem_tpu.models import mae3d as jmae
from octcubem_tpu.models import vit_st as jvit
from octcubem_tpu.train import mae_engine as jeng
from octcubem_tpu.train import optim as jopt
from octcubem_tpu.train.train_state import TrainState as JState
from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.models import mae3d as tmae
from octcubem_tpu_torch.models import vit_st as tvit
from octcubem_tpu_torch.train import mae_engine as teng
from octcubem_tpu_torch.train import optim as topt
from octcubem_tpu_torch.train.train_state import TrainState as TState

from test_torch_port_mae import assert_grads_close, jax_init, jax_noise, perturb
from test_torch_port_train import EPS, TOL_METRIC, TOL_PARAM, _replay_noise

VIT_KW = dict(num_frames=6, t_patch_size=3, img_size=112, patch_size=14,
              in_chans=1, num_classes=4, embed_dim=160, depth=2, num_heads=2,
              high_res_input_size=224, head_type="dropout")
MAE_KW = dict(patch_size=14, in_chans=1, embed_dim=160, depth=2, num_heads=2,
              decoder_embed_dim=160, decoder_depth=1, decoder_num_heads=2,
              num_frames=6, t_patch_size=3, pred_t_dim=6, input_size=112,
              high_res_input_size=224)


def _volume(b, seed, size=112):
    return np.random.default_rng(seed).standard_normal(
        (b, 6, size, size, 1)).astype(np.float32)


def test_vith_constructors_match_jax():
    """Both registries' ViT-H/14: patch 14, 1280 wide, 32 blocks, 16 heads
    of 80 -- the head_dim the packed kernels do not serve."""
    with torch.device("meta"):
        tv = tvit.vit_huge_patch14(num_frames=48, img_size=224)
        tm = tmae.mae_vit_huge_patch14(input_size=224, high_res_input_size=448)
    jv = jvit.vit_huge_patch14(num_frames=48, img_size=224)
    jm = jmae.mae_vit_huge_patch14(input_size=224, high_res_input_size=448)
    for t, j, blocks in ((tv, jv, tv.blocks), (tm, jm, tm.blocks)):
        assert (t.patch_embed.patch_size, len(blocks)) == (j.patch_size, j.depth)
        assert t.cls_token.shape[-1] == j.embed_dim == 1280
        assert blocks[0].mixer.num_heads == j.num_heads == 16
    assert tm.pos_embed_spatial.shape == (1, 32 * 32, 1280)
    assert tvit.vit_huge_patch14(depth=2, num_frames=48).blocks.__len__() == 2


def _vit_params(x, seed):
    jm = jvit.VisionTransformerST(**VIT_KW, attn_impl="flash")
    params = perturb(jax.jit(jm.init)(jax.random.key(seed), jnp.asarray(x)),
                     seed + 3)
    tm = tvit.VisionTransformerST(**VIT_KW)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm.eval()


def test_vith_classifier_forward_and_grad_match_jax():
    """Logits (the JAX full-model fp32 tolerance, 1e-5 relative, with a
    5e-5 floor as in test_torch_port_vit_st.py) and d sum(logits * w) /
    d params per leaf (5e-4 of the leaf's largest entry)."""
    x = _volume(2, 9)
    jm, params, tm = _vit_params(x, 0)
    w = np.random.default_rng(4).standard_normal((2, 4)).astype(np.float32)

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x))
        return (out * w).sum(), out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    out = tm(torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=5e-5, rtol=1e-5)
    assert_grads_close(state_dict_from_jax(jgrads), tm)


def test_vith_classifier_high_res_input_matches_jax():
    """A 224-pixel input takes the high-res patch embed: 2 x 16 x 16 + cls
    = 513 tokens (B3 at m = 512), pos embeds at their stored grid.  Logits
    as above."""
    x = _volume(1, 10, size=224)
    jm, params, tm = _vit_params(x, 1)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.inference_mode():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-5, rtol=1e-5)


def test_vith_mae_forward_and_grad_match_jax():
    """(loss, frame_losses, pred, mask) to 1e-5 and d loss / d params per
    leaf to 5e-4 of the leaf's largest entry, as in
    test_torch_port_mae.py."""
    x = _volume(1, 5)
    jm, params = jax_init(MAE_KW, x, 0.9)
    key = jax.random.key(11)
    noise = jax_noise(jm, params, x, key)

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x), mask_ratio=0.9,
                       rngs={"masking": key})
        return out[0], out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tm = tmae.MaskedAutoencoderViT3D(**MAE_KW)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    out = tm(torch.from_numpy(x), 0.9, torch.from_numpy(noise))
    out[0].backward()
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    assert int(out[3][0].sum()) == 128 - 12  # 12 kept: 13 encoder tokens
    for name, got, r in zip(("loss", "frame_losses", "pred"), out[:3], ref[:3]):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(r),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    assert_grads_close(state_dict_from_jax(jgrads), tm)


def test_vith_mae_train_step_matches_jax():
    """One make_mae_train_step step against one JAX step from the same
    params, batch and noise: loss and grad norm, then every param, at
    test_torch_port_train.py's tolerances (AdamW eps 1e-5, and why)."""
    b3 = _volume(2, 21)
    jm, params = jax_init(MAE_KW, b3, 0.9)
    tx_j = jopt.build_fused_adamw(params, 1e-3, weight_decay=0.05, eps=EPS)
    s_j = JState.create(params, tx_j, jax.random.key(2))
    step_j = jeng.make_mae_train_step(jm, tx_j, donate=False)
    tm = tmae.MaskedAutoencoderViT3D(**MAE_KW)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    tx_t = topt.build_fused_adamw(tm, 1e-3, weight_decay=0.05, eps=EPS)
    s_t = TState.create(tm, tx_t, seed=0)
    step_t = teng.make_mae_train_step(tm, tx_t)
    noise = _replay_noise(jm, s_j.params, s_j.rng, b3, None, 1, False)
    s_j, m_j = step_j(s_j, jnp.asarray(b3), mask_ratio=0.9)
    s_t, m_t = step_t(s_t, torch.from_numpy(b3), 0.9, noise=noise)
    for k in ("loss", "grad_norm", "frame_losses"):
        np.testing.assert_allclose(m_t[k].numpy(), np.asarray(m_j[k]),
                                   **TOL_METRIC, err_msg=k)
    ref, before = state_dict_from_jax(s_j.params), state_dict_from_jax(params)
    moved = 0
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   **TOL_PARAM, err_msg=name)
        moved += not torch.equal(p.detach(), before[name])
    assert moved > len(ref) // 2
