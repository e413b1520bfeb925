"""Port parity: octcubem_tpu_torch's attention ops against the JAX package.

The port's plain B1 (the CPU side of ops/flash_attention.fwd_packed) and
its public packed entry points are held against the JAX packed flash
path, whose Pallas kernel runs in interpret mode on the CPU.  fp32
tolerances are the JAX kernel tests' own: o at 5e-5; lse at 1e-4
absolute.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from octcubem_tpu.ops import attention as jattn
from octcubem_tpu.ops import flash_attention as jfa
from octcubem_tpu_torch.ops import _cuda
from octcubem_tpu_torch.ops import attention as tattn
from octcubem_tpu_torch.ops import flash_attention as tfa

# (n, heads, head_dim, q multiplier): cls-prefixed n (129, 257), one n
# with no cls fold (200), every head_dim, and logits far above the clamp
CASES = [(129, 2, 64, 1.0), (257, 4, 32, 1.0), (200, 2, 64, 1.0),
         (129, 1, 128, 1.0), (129, 1, 256, 1.0), (129, 2, 64, 40.0)]


def _qkv(n, h, d, qmul, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (1, n, 3 * h * d)).astype(np.float32)
    x[..., :h * d] *= qmul
    return x


@pytest.mark.parametrize("n,h,d,qmul", CASES)
def test_packed_qkv_matches_jax(n, h, d, qmul):
    x = _qkv(n, h, d, qmul)
    ref = np.asarray(jfa.flash_attention_packed_qkv(jnp.asarray(x), h))
    out = tfa.flash_attention_packed_qkv(torch.from_numpy(x), h).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("n,h,d,qmul", CASES)
def test_fwd_packed_lse_matches_jax(n, h, d, qmul):
    """(o, lse) of the kernel's own tokens, against the JAX private
    _fwd_packed_qkv with the arguments the public function gives it."""
    x = _qkv(n, h, d, qmul, seed=1)
    hd, scale = h * d, d ** -0.5
    xj = jnp.asarray(x)
    if n % 128 == 1:
        block = jfa._pick_block(n - 1, jfa.FWD_BLOCK_TARGET)
        o_ref, lse_ref = jfa._fwd_packed_qkv(
            xj[:, 1:], xj[:, :1, hd:2 * hd], xj[:, :1, 2 * hd:], scale,
            block, d, 0)
    else:
        zc = jnp.zeros((1, 1, hd), xj.dtype)
        o_ref, lse_ref = jfa._fwd_packed_qkv(
            xj, zc, zc, scale, jfa._pick_block(n, jfa.FWD_BLOCK_TARGET), d, 1)
    xt = torch.from_numpy(x)
    q, k, v = xt[..., :hd], xt[..., hd:2 * hd], xt[..., 2 * hd:]
    if n % 128 == 1:
        o, lse = tfa.fwd_packed(q[:, 1:], k[:, 1:], v[:, 1:], k[:, :1],
                                v[:, :1], h, scale)
    else:
        o, lse = tfa.fwd_packed(q, k, v, None, None, h, scale)
    assert lse.dtype == torch.float32 and lse.shape == lse_ref.shape
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=5e-5,
                               rtol=5e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("n", [129, 200])
def test_packed_separate_qkv_matches_jax(n):
    h, d = 2, 64
    x = _qkv(n, h, d, 1.0, seed=2)
    q, k, v = (x[..., i * h * d:(i + 1) * h * d].copy() for i in range(3))
    ref = np.asarray(jfa.flash_attention_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h))
    out = tfa.flash_attention_packed(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), h).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-5, rtol=5e-5)


def test_naive_attention_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 2, 65, 32)).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(jattn.naive_attention(*map(jnp.asarray, (q, k, v))))
    out = tattn.naive_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-6, rtol=5e-6)


@pytest.mark.parametrize("impl", ["auto", "flash", "naive"])
def test_qkv_dispatch_matches_jax_naive(impl):
    """Every impl the port serves agrees with the JAX naive path."""
    x = _qkv(129, 2, 64, 1.0, seed=4)
    ref = np.asarray(jattn.multi_head_attention_qkv(jnp.asarray(x), 2,
                                                    impl="naive"))
    out = tattn.multi_head_attention_qkv(torch.from_numpy(x), 2,
                                         impl=impl).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-5, rtol=5e-5)


def test_cpu_call_never_touches_cuda_loader(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("CUDA loader reached from a CPU call")

    monkeypatch.setattr(_cuda, "library", refuse)
    monkeypatch.setattr(_cuda, "build", refuse)
    before = dict(_cuda.launches)
    x = torch.from_numpy(_qkv(129, 2, 64, 1.0))
    tattn.multi_head_attention_qkv(x, 2)
    tfa.flash_attention_packed_qkv(x[:, :100], 2)
    assert _cuda.launches == before


def test_unsupported_inputs_raise():
    # head_dim 48, which B1 does not serve, takes the [B, H, N, D] path as
    # in the JAX package (its fallback), and agrees with it
    x = _qkv(129, 2, 48, 1.0, seed=5)
    ref = np.asarray(jfa.flash_attention_packed_qkv(jnp.asarray(x), 2))
    out = tfa.flash_attention_packed_qkv(torch.from_numpy(x), 2).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-5, rtol=5e-5)
    with pytest.raises(ValueError, match="heads"):  # 96 is not 5 heads
        tfa.flash_attention_packed_qkv(torch.zeros((1, 129, 3 * 96)), 5)
    q = torch.zeros((1, 129, 128))
    with pytest.raises(ValueError, match="CUDA"):  # host pointers never reach it
        tfa.fwd_packed_cuda(q, q, q, None, None, 2, 0.125)
    with pytest.raises(NotImplementedError, match="A14"):  # head parallel
        tattn.multi_head_attention_qkv(torch.zeros((1, 129, 384)), 2,
                                       impl="flash_tp")
    with pytest.raises(RuntimeError, match="use_sequence_parallel"):
        tattn.multi_head_attention_qkv(torch.zeros((1, 129, 384)), 2,
                                       impl="flash_sp")
    with pytest.raises(ValueError):
        tattn.multi_head_attention_qkv(torch.zeros((1, 129, 384)), 2,
                                       impl="bogus")
