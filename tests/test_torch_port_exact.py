"""Port parity: the exact online softmax (TPU kernel B6, ``no_max=False``)
against the JAX package.

``flash_attention(no_max=False)`` (B6 / B7 over all n tokens, no cls
split) and ``flash_attention_rect(no_max=False)`` (with ``kv_valid``) run
B6's plain version and B7's exact branch on CPU tensors; the JAX side
runs its ``_fwd_kernel`` and ``_fused_bwd_kernel`` in interpret mode.
Queries x 1 and x 8 (scaled logits of standard deviation 1 and 8; the
fixed shift's clamp at 40 is where only the exact softmax stays right,
which the card checks at larger logits).  fp32 tolerances
are the JAX kernel tests' own: 5e-5 on outputs, 5e-4 on gradients, lse
at 1e-4 absolute.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from octcubem_tpu.ops import flash_attention as jfa
from octcubem_tpu_torch.ops import attention as tattn
from octcubem_tpu_torch.ops import flash_attention as tfa

TOL_O = dict(atol=5e-5, rtol=5e-5)
TOL_G = dict(atol=5e-4, rtol=5e-4)


def _jax_vjp(fn, args, g):
    def run(args, g):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(g)
    return jax.jit(run)(args, g)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("qmul", [1.0, 8.0])
@pytest.mark.parametrize("n", [100, 129, 256])
def test_flash_attention_exact_matches_jax(n, qmul):
    """Output and q, k, v gradients; n = 129 is cls-prefixed, which the
    exact path does not split."""
    rng = np.random.default_rng(n)
    q, k, v, g = (_rand(rng, 1, 2, n, 32) for _ in range(4))
    q *= qmul
    out_ref, grads_ref = _jax_vjp(
        lambda a, b, c: jfa.flash_attention(a, b, c, no_max=False),
        list(map(jnp.asarray, (q, k, v))), jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*ts, no_max=False)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               **TOL_O)
    for name, t, ref in zip("qkv", ts, grads_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), **TOL_G,
                                   err_msg=f"d{name}")


# (nq, nk, kv_valid): tests/test_sequence_parallel.py's pairs, then query
# shards against padded keys
RECT = [(100, 260, None), (256, 256, None), (64, 513, None), (300, 128, None),
        (70, 260, 250), (64, 513, 500)]


@pytest.mark.parametrize("qmul", [1.0, 8.0])
@pytest.mark.parametrize("nq,nk,kv_valid", RECT)
def test_flash_attention_rect_exact_matches_jax(nq, nk, kv_valid, qmul):
    """Through the zeroing the sequence-parallel layer applies: k / v rows
    at or past kv_valid are zeroed before the call, so their gradient is
    discarded on both sides.  (The JAX exact forward masks them with
    NEG_INF, but its backward does not, so nonzero tails would leak into
    its dq; the port's kernels mask both.)"""
    rng = np.random.default_rng(nq + nk)
    q, g = (_rand(rng, 1, 2, nq, 32) for _ in range(2))
    k, v = (_rand(rng, 1, 2, nk, 32) for _ in range(2))
    q *= qmul
    keep = (np.arange(nk) < (nk if kv_valid is None else kv_valid))
    keep = keep.astype(np.float32)[:, None]

    out_ref, grads_ref = _jax_vjp(
        lambda a, b, c: jfa.flash_attention_rect(
            a, b * keep, c * keep, no_max=False, kv_valid=kv_valid),
        list(map(jnp.asarray, (q, k, v))), jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    mask = torch.from_numpy(keep)
    out = tfa.flash_attention_rect(ts[0], ts[1] * mask, ts[2] * mask,
                                   no_max=False, kv_valid=kv_valid)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               **TOL_O)
    for name, t, ref in zip("qkv", ts, grads_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), **TOL_G,
                                   err_msg=f"d{name}")


def test_rect_exact_masks_the_tail_whatever_it_holds():
    """kv_valid masks the keys past it exactly: k / v rows there may hold
    anything (no zeroing needed), and their dk / dv are 0."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(8.0 * _rand(rng, 1, 2, 40, 32))
    k, v = (torch.from_numpy(_rand(rng, 1, 2, 90, 32)).requires_grad_()
            for _ in range(2))
    out = tfa.flash_attention_rect(q, k, v, no_max=False, kv_valid=77)
    ref = tattn.naive_attention(q, k[:, :, :77], v[:, :, :77])
    torch.testing.assert_close(out, ref, **TOL_O)
    out.sum().backward()
    assert (k.grad[:, :, 77:] == 0).all() and (v.grad[:, :, 77:] == 0).all()


def test_exact_lse_and_its_cotangent_match_jax():
    """(o, lse) of FlashBH(no_max=False) against the JAX _flash_bh with
    no_max=False, and the gradients of sum(o g) + sum(lse g_lse): the lse
    cotangent folds into delta on both sides."""
    b, h, n, d = 2, 2, 200, 80
    rng = np.random.default_rng(5)
    q, k, v, g = (_rand(rng, b, h, n, d) for _ in range(4))
    q *= 8.0
    g_lse = 0.1 * _rand(rng, b, h, n)
    scale, block = d ** -0.5, jfa._pick_block(n, jfa.FWD_BLOCK_TARGET)

    def jfn(q, k, v):
        o, lse = jfa._flash_bh(*(a.reshape(b * h, n, d) for a in (q, k, v)),
                               scale, block, block, False)
        return o.reshape(b, h, n, d), lse.reshape(b, h, n)

    (o_ref, lse_ref), grads_ref = _jax_vjp(
        jfn, list(map(jnp.asarray, (q, k, v))),
        (jnp.asarray(g), jnp.asarray(g_lse)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = tfa.FlashBH.apply(*ts, scale, False)
    ((o * torch.from_numpy(g)).sum()
     + (lse * torch.from_numpy(g_lse)).sum()).backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), **TOL_O)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_ref),
                               atol=1e-4, rtol=0)
    for name, t, ref in zip("qkv", ts, grads_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), **TOL_G,
                                   err_msg=f"d{name}")


def test_bwd_takes_a_precomputed_delta():
    """bwd_bh with delta given (ring attention's once-per-backward delta)
    equals bwd_bh forming delta from o, dO and g_lse."""
    rng = np.random.default_rng(6)
    q, k, v, do = (torch.from_numpy(_rand(rng, 1, 2, 50, 32))
                   for _ in range(4))
    g_lse = torch.from_numpy(0.1 * _rand(rng, 1, 2, 50))
    o, lse = tfa.fwd_bh(q, k, v, None, None, 0.2, no_max=False)
    want = tfa.bwd_bh(q, k, v, None, None, o, lse, do, g_lse, 0.2, False)
    delta = (do * o).sum(-1) - g_lse
    got = tfa.bwd_bh(q, k, v, None, None, None, lse, do, None, 0.2, False,
                     delta=delta)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_exact_refuses_the_cls_fold():
    q = torch.zeros((1, 2, 10, 32))
    with pytest.raises(ValueError, match="cls fold"):
        tfa.fwd_bh(q, q, q, q[:, :, :1], q[:, :, :1], 0.1, no_max=False)
