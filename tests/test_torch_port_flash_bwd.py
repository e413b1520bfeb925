"""Port parity: the backward of the port's packed flash attention (B2)
against the JAX package's packed backward.

The port's plain B2 (the CPU side of ops/flash_attention.bwd_packed) is
held against the JAX ``_bwd_packed_impl`` on the same (o, lse, dO, g_lse),
and the gradients the port's autograd Functions give are held against
``jax.vjp`` of ``flash_attention_packed_qkv`` / ``flash_attention_packed``;
the JAX Pallas kernels run in interpret mode on the CPU.  Lengths with a
cls fold (n % 128 == 1) and without, every head_dim, and logits far above
the clamp.  At head_dim 32 the JAX side needs H >= 4 and at 64 an even H,
or it leaves the packed path.  fp32 at 5e-4, the JAX kernel-gradient
tolerance (tests/test_flash_attention.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from octcubem_tpu.ops import flash_attention as jfa
from octcubem_tpu_torch.ops import flash_attention as tfa

TOL = dict(atol=5e-4, rtol=5e-4)

# (n, heads, head_dim, q multiplier): every (H, D) once with the cls fold
# and once without; the largest lengths (513, 512) once each; q x 40 puts
# most logits above the clamp
CASES = [(129, 4, 32, 1.0), (200, 4, 32, 1.0), (513, 4, 32, 1.0),
         (257, 2, 64, 1.0), (512, 2, 64, 1.0), (129, 1, 128, 1.0),
         (200, 1, 128, 1.0), (129, 1, 256, 1.0), (200, 1, 256, 1.0),
         (129, 2, 64, 40.0), (200, 2, 64, 40.0)]


def _data(n, h, d, qmul, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n, 3 * h * d)).astype(np.float32)
    x[..., :h * d] *= qmul
    g = rng.standard_normal((2, n, h * d)).astype(np.float32)
    return x, g


@pytest.mark.parametrize("n,h,d,qmul", CASES)
def test_packed_qkv_grad_matches_jax(n, h, d, qmul):
    """qkv.grad through FlashPackedQKV (B1 + B2) and the plain cls query
    row, against jax.vjp of the JAX public function."""
    x, g = _data(n, h, d, qmul, seed=n + d)
    out_ref, vjp = jax.vjp(lambda a: jfa.flash_attention_packed_qkv(a, h),
                           jnp.asarray(x))
    (grad_ref,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    out = tfa.flash_attention_packed_qkv(xt, h)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               atol=5e-5, rtol=5e-5)
    assert np.isfinite(xt.grad.numpy()).all()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grad_ref), **TOL)


@pytest.mark.parametrize("n,h,d", [(129, 2, 64), (200, 4, 32)])
def test_packed_separate_grad_matches_jax(n, h, d):
    """q, k, v grads through FlashPacked against the JAX sliced path."""
    x, g = _data(n, h, d, 1.0, seed=3)
    hd = h * d
    q, k, v = (np.ascontiguousarray(x[..., i * hd:(i + 1) * hd])
               for i in range(3))
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention_packed(a, b, c, h),
                     *map(jnp.asarray, (q, k, v)))
    refs = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tfa.flash_attention_packed(*ts, h).backward(torch.from_numpy(g))
    for t, ref in zip(ts, refs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("n,h,d,qmul", [
    (129, 4, 32, 1.0), (257, 2, 64, 1.0), (200, 2, 64, 1.0),
    (129, 1, 128, 40.0), (200, 1, 256, 1.0)])
def test_bwd_packed_plain_matches_jax_impl(n, h, d, qmul):
    """bwd_packed_plain against the JAX _bwd_packed_impl on the JAX
    forward's (o, lse), with a nonzero g_lse.  Without the cls fold the
    JAX side folds a zero phantom cls, whose gradients nobody reads."""
    x, g = _data(n, h, d, qmul, seed=7 * n + d)
    hd, scale = h * d, d ** -0.5
    xj = jnp.asarray(x)
    cls = n % 128 == 1
    if cls:
        q, k, v = xj[:, 1:, :hd], xj[:, 1:, hd:2 * hd], xj[:, 1:, 2 * hd:]
        kc, vc = xj[:, :1, hd:2 * hd], xj[:, :1, 2 * hd:]
        block, extra = jfa._pick_block(n - 1, jfa.FWD_BLOCK_TARGET), 0
        g = g[:, 1:]
    else:
        q, k, v = xj[..., :hd], xj[..., hd:2 * hd], xj[..., 2 * hd:]
        kc = vc = jnp.zeros((2, 1, hd), xj.dtype)
        block, extra = jfa._pick_block(n, jfa.FWD_BLOCK_TARGET), 1
    o, lse = jfa._fwd_packed(q, k, v, kc, vc, scale, block, d, extra)
    g_lse = np.random.default_rng(n).standard_normal(
        np.shape(lse)).astype(np.float32) * 0.1
    refs = jfa._bwd_packed_impl(scale, d, q, k, v, kc, vc, o, lse,
                                jnp.asarray(g), jnp.asarray(g_lse))

    def t(a):
        return torch.from_numpy(np.array(a))

    grads = tfa.bwd_packed_plain(
        t(q), t(k), t(v), t(kc) if cls else None, t(vc) if cls else None,
        t(o), t(lse), t(g), t(g_lse), h, scale)
    names = ("dq", "dk", "dv", "dkc", "dvc")[:5 if cls else 3]
    for name, got, ref in zip(names, grads, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL,
                                   err_msg=name)
    if not cls:
        assert grads[3] is None and grads[4] is None


def test_bwd_packed_writes_into_given_buffers():
    """bwd_packed's ``out``: the column views of one dqkv buffer receive
    exactly what the allocating call returns."""
    x, g = _data(129, 2, 64, 1.0, seed=11)
    xt = torch.from_numpy(x)
    args = tfa._split_qkv(xt, True)
    o, lse = tfa.fwd_packed(*args, 2, 0.125)
    gt = torch.from_numpy(g[:, 1:])
    ref = tfa.bwd_packed(*args, o, lse, gt, None, 2, 0.125)
    dqkv = torch.full_like(xt, float("nan"))
    got = tfa.bwd_packed(*args, o, lse, gt, None, 2, 0.125,
                         out=tfa._split_qkv(dqkv, True))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.isnan(dqkv[:, 0, :128]).all()  # the cls query's columns
    assert not torch.isnan(dqkv[:, 1:]).any()


def test_lse_output_is_differentiable():
    """g_lse reaches B2: the gradient of sum(lse) through FlashPackedQKV
    matches the same through the plain forward under autograd."""
    x, _ = _data(200, 2, 64, 1.0, seed=12)
    xt = torch.from_numpy(x).requires_grad_()
    _, lse = tfa.FlashPackedQKV.apply(xt, 2, 0.125, False)
    lse.sum().backward()
    xr = torch.from_numpy(x).requires_grad_()
    hd = 128
    _, lse_ref = tfa.fwd_packed_plain(xr[..., :hd], xr[..., hd:2 * hd],
                                      xr[..., 2 * hd:], None, None, 2, 0.125)
    lse_ref.sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(), **TOL)
