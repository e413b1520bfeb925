"""Port parity: the port's [B, H, N, D] flash attention against the JAX
package.

``flash_attention`` (B3 / B4 with the cls fold, B5 / B7 without),
``flash_attention_rect`` (B5 / B7 with ``kv_valid``), the private
``(o, lse)`` Functions with an lse cotangent, B7's exact-softmax branch,
the packed path's reroute for head dims B1 / B2 do not serve (48 and 80)
and its ``no_max=False`` route (B6 / B7) are held against the JAX package, whose Pallas kernels run in
interpret mode on the CPU; the port runs the kernels' plain versions.
Every length of ROADMAP A2's list appears (128, 129, 200, 256, 257, 385,
513, 577, 700) and every head_dim (32 at 4 heads, 64, 80, 128).  The
port's inputs are the [B, H, N, D] views of one fused [B, N, 3*H*D]
buffer, as the packed path hands them over.  fp32 tolerances are the
JAX kernel tests' own (tests/test_flash_attention.py): 5e-5 for outputs,
5e-4 for gradients; lse at 1e-4 absolute.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from octcubem_tpu.ops import attention as jattn
from octcubem_tpu.ops import flash_attention as jfa
from octcubem_tpu_torch.ops import attention as tattn
from octcubem_tpu_torch.ops import flash_attention as tfa

TOL_O = dict(atol=5e-5, rtol=5e-5)
TOL_G = dict(atol=5e-4, rtol=5e-4)


def _data(b, n, h, d, qmul=1.0, seed=0):
    """x [B, N, 3, H, D] (the fused buffer's layout) and a cotangent
    g [B, H, N, D], numpy fp32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, 3, h, d)).astype(np.float32)
    x[:, :, 0] *= qmul
    g = rng.standard_normal((b, h, n, d)).astype(np.float32)
    return x, g


def _jax_qkv(x):
    return [jnp.asarray(np.ascontiguousarray(x[:, :, i].transpose(0, 2, 1, 3)))
            for i in range(3)]


def _torch_qkv(x):
    """Leaf buffer and its q, k, v [B, H, N, D] views (row stride 3*H*D,
    head stride D)."""
    buf = torch.from_numpy(x.copy()).requires_grad_()
    return buf, [buf[:, :, i].transpose(1, 2) for i in range(3)]


def _jax_vjp(fn, args, g):
    """(fn(*args), the cotangent g pulled back to args), jitted: the
    interpret-mode kernels compile once per shape instead of running op
    by op."""
    def run(args, g):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(g)
    return jax.jit(run)(args, g)


def _buffer_grads(buf):
    """The gradient of the fused buffer as [B, H, N, D] per q, k, v."""
    return [buf.grad[:, :, i].transpose(1, 2).numpy() for i in range(3)]


# (n, heads, head_dim, q multiplier): each listed n once, each head_dim
# at least twice, n % 128 == 1 (the cls split) at 129, 257, 385, 513 and
# 577; q x 40 puts most logits above the clamp, with and without the fold
CASES = [(128, 4, 32, 1.0), (129, 2, 80, 1.0), (200, 2, 64, 1.0),
         (256, 1, 128, 1.0), (257, 4, 32, 1.0), (385, 2, 80, 1.0),
         (513, 1, 64, 1.0), (577, 1, 80, 1.0), (700, 1, 128, 1.0),
         (257, 2, 80, 40.0), (200, 2, 80, 40.0)]


@pytest.mark.parametrize("n,h,d,qmul", CASES)
def test_flash_attention_matches_jax(n, h, d, qmul):
    """Output and q, k, v gradients against jax.vjp of the JAX
    flash_attention."""
    x, g = _data(1, n, h, d, qmul, seed=n + d)
    out_ref, grads_ref = _jax_vjp(jfa.flash_attention, _jax_qkv(x),
                                  jnp.asarray(g))
    buf, qkv = _torch_qkv(x)
    out = tfa.flash_attention(*qkv)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               **TOL_O)
    for name, got, ref in zip("qkv", _buffer_grads(buf), grads_ref):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(ref), **TOL_G,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("cls", [False, True])
def test_private_functions_lse_and_its_cotangent_match_jax(cls):
    """(o, lse) of FlashBH / FlashBHCls against the JAX _flash_bh /
    _flash_bh_cls, and the gradients of sum(o g) + sum(lse g_lse), so the
    lse cotangent folds into delta on both sides.  B=2: the batch and
    head strides of the views."""
    b, h, d = 2, 2, 80
    n = 129 if cls else 200
    x, g = _data(b, n, h, d, seed=3 + cls)
    g_lse = 0.1 * np.random.default_rng(9).standard_normal(
        (b, h, n - cls)).astype(np.float32)
    scale = d ** -0.5
    bh = b * h

    def jfn(q, k, v):
        q, k, v = (a.reshape(bh, n, d) for a in (q, k, v))
        if cls:
            o, lse = jfa._flash_bh_cls(q[:, 1:], k[:, 1:], v[:, 1:], k[:, :1],
                                       v[:, :1], scale, 128)
        else:
            block = jfa._pick_block(n, jfa.FWD_BLOCK_TARGET)
            o, lse = jfa._flash_bh(q, k, v, scale, block, block, True)
        return o.reshape(b, h, n - cls, d), lse.reshape(b, h, n - cls)

    g_o = g[:, :, cls:]
    (o_ref, lse_ref), grads_ref = _jax_vjp(
        jfn, _jax_qkv(x), (jnp.asarray(g_o), jnp.asarray(g_lse)))
    buf, (q, k, v) = _torch_qkv(x)
    if cls:
        o, lse = tfa.FlashBHCls.apply(q[:, :, 1:], k[:, :, 1:], v[:, :, 1:],
                                      k[:, :, :1], v[:, :, :1], scale)
    else:
        o, lse = tfa.FlashBH.apply(q, k, v, scale)
    ((o * torch.from_numpy(g_o)).sum()
     + (lse * torch.from_numpy(g_lse)).sum()).backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), **TOL_O)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_ref),
                               atol=1e-4, rtol=0)
    for name, got, ref in zip("qkv", _buffer_grads(buf), grads_ref):
        np.testing.assert_allclose(got, np.asarray(ref), **TOL_G,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("nq,nk,kv_valid,h,d", [
    (70, 260, 250, 2, 80),    # a query shard against padded keys
    (300, 129, None, 4, 32)])  # more queries than keys, all valid
def test_flash_attention_rect_matches_jax(nq, nk, kv_valid, h, d):
    """Through the zeroing wrapper the JAX sequence-parallel path uses:
    the k / v rows at or past kv_valid are zeroed before the call, so
    their gradient is discarded on both sides (the JAX backward leaves
    values in those rows; the port's writes zeros)."""
    rng = np.random.default_rng(nq)
    q = rng.standard_normal((1, h, nq, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, h, nk, d)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((1, h, nq, d)).astype(np.float32)
    keep = (np.arange(nk) < (nk if kv_valid is None else kv_valid))
    keep = keep.astype(np.float32)[:, None]

    def jfn(q, k, v):
        return jfa.flash_attention_rect(q, k * keep, v * keep,
                                        kv_valid=kv_valid)

    out_ref, grads_ref = _jax_vjp(jfn, list(map(jnp.asarray, (q, k, v))),
                                  jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    mask = torch.from_numpy(keep)
    out = tfa.flash_attention_rect(ts[0], ts[1] * mask, ts[2] * mask,
                                   kv_valid=kv_valid)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               **TOL_O)
    for name, t, ref in zip("qkv", ts, grads_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), **TOL_G,
                                   err_msg=f"d{name}")


def test_rect_plain_writes_zero_tail_gradients():
    """Without the zeroing wrapper the port's B7 gives dk = dv = 0 in the
    rows at or past kv_valid, whatever k and v hold there."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, m, 32)).astype(
        np.float32)) for m in (40, 90, 90))
    o, lse = tfa.fwd_bh_plain(q, k, v, None, None, 0.2, kv_valid=77)
    ref, _ = tfa.fwd_bh_plain(q, k[:, :, :77], v[:, :, :77], None, None, 0.2)
    assert torch.equal(o, ref)
    dq, dk, dv, _, _ = tfa.bwd_bh_plain(q, k, v, None, None, o, lse,
                                        torch.ones_like(o), None, 0.2,
                                        kv_valid=77)
    assert dk.shape == k.shape and (dk[:, :, 77:] == 0).all()
    assert (dv[:, :, 77:] == 0).all() and dv[:, :, :77].abs().max() > 0


def test_exact_softmax_backward_matches_jax():
    """B7's no_max=False branch (p = exp(s - lse), no clamp, ds unmasked),
    given the exact softmax's (o, lse), against the JAX _flash_bh with
    no_max=False; logits far above the fixed-shift clamp."""
    b, h, n, d = 1, 2, 200, 80
    x, g = _data(b, n, h, d, qmul=30.0, seed=4)
    scale = d ** -0.5
    block = jfa._pick_block(n, jfa.FWD_BLOCK_TARGET)

    def jfn(q, k, v):
        o, _ = jfa._flash_bh(q.reshape(b * h, n, d), k.reshape(b * h, n, d),
                             v.reshape(b * h, n, d), scale, block, block,
                             False)
        return o.reshape(b, h, n, d)

    _, grads_ref = _jax_vjp(jfn, _jax_qkv(x), jnp.asarray(g))
    _, (q, k, v) = _torch_qkv(x)
    q, k, v = (t.detach() for t in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)
    got = tfa.bwd_bh_plain(q, k, v, None, None, o, lse, torch.from_numpy(g),
                           None, scale, no_max=False)
    for name, a, ref in zip("qkv", got, grads_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **TOL_G,
                                   err_msg=f"d{name}")
    clamped = tfa.bwd_bh_plain(q, k, v, None, None, o, lse,
                               torch.from_numpy(g), None, scale)
    assert not torch.allclose(clamped[0], got[0])  # the branches differ here


@pytest.mark.parametrize("n,d", [(129, 48), (200, 80)])
def test_packed_reroutes_head_dims_b1_does_not_serve(n, d, monkeypatch):
    """flash_attention_packed_qkv at head_dim 48 and 80 runs the
    [B, H, N, D] path (and never B1), as the JAX package falls back; output
    and qkv.grad match jax.vjp of the JAX function."""
    h = 2
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n, 3 * h * d)).astype(np.float32)
    g = rng.standard_normal((2, n, h * d)).astype(np.float32)
    out_ref, (grad_ref,) = _jax_vjp(
        lambda a: jfa.flash_attention_packed_qkv(a, h), [jnp.asarray(x)],
        jnp.asarray(g))
    calls = []

    def refuse(*a, **k):
        raise AssertionError("B1 reached at a head_dim it does not serve")

    def count(fn):
        def wrapped(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tfa, "fwd_packed", refuse)
    monkeypatch.setattr(tfa, "fwd_bh", count(tfa.fwd_bh))
    monkeypatch.setattr(tfa, "bwd_bh", count(tfa.bwd_bh))
    xt = torch.from_numpy(x).requires_grad_()
    out = tfa.flash_attention_packed_qkv(xt, h)
    out.backward(torch.from_numpy(g))
    assert calls == ["fwd_bh", "bwd_bh"]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               **TOL_O)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grad_ref), **TOL_G)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("d", [64, 80])
def test_packed_exact_softmax_matches_jax(d, fused):
    """flash_attention_packed(_qkv)(no_max=False) routes to
    flash_attention on the [B, H, N, D] views (B6 / B7), as the JAX
    functions do: output and gradients against jax.vjp of the JAX
    function, logits x 8 (far past the fixed shift's clamp)."""
    h, n = 2, 129
    rng = np.random.default_rng(d + fused)
    x = rng.standard_normal((2, n, 3 * h * d)).astype(np.float32)
    x[..., :h * d] *= 8.0
    g = rng.standard_normal((2, n, h * d)).astype(np.float32)
    hd = h * d
    if fused:
        out_ref, grads_ref = _jax_vjp(
            lambda a: jfa.flash_attention_packed_qkv(a, h, no_max=False),
            [jnp.asarray(x)], jnp.asarray(g))
        xt = torch.from_numpy(x).requires_grad_()
        ts = [xt]
        out = tfa.flash_attention_packed_qkv(xt, h, no_max=False)
    else:
        parts = [np.ascontiguousarray(x[..., i * hd:(i + 1) * hd])
                 for i in range(3)]
        out_ref, grads_ref = _jax_vjp(
            lambda q, k, v: jfa.flash_attention_packed(q, k, v, h,
                                                       no_max=False),
            [jnp.asarray(a) for a in parts], jnp.asarray(g))
        ts = [torch.from_numpy(a).requires_grad_() for a in parts]
        out = tfa.flash_attention_packed(*ts, h, no_max=False)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               **TOL_O)
    for t, ref in zip(ts, grads_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), **TOL_G)


@pytest.mark.parametrize("impl", ["auto", "flash", "naive"])
def test_multi_head_attention_matches_jax_naive(impl):
    x, _ = _data(2, 129, 2, 80, seed=6)
    ref = np.asarray(jattn.multi_head_attention(*_jax_qkv(x), impl="naive"))
    _, qkv = _torch_qkv(x)
    with torch.no_grad():
        out = tattn.multi_head_attention(*qkv, impl=impl).numpy()
    np.testing.assert_allclose(out, ref, **TOL_O)


def test_exact_softmax_forward_and_bad_kv_valid_refused():
    """no_max=False runs B6's plain version (no cls split at n = 129) and
    matches the JAX exact kernel; a kv_valid out of range and host
    pointers are refused."""
    x, _ = _data(1, 129, 2, 80, qmul=8.0, seed=7)
    qkv = _jax_qkv(x)
    _, (q, k, v) = _torch_qkv(x)
    with torch.no_grad():
        out = tfa.flash_attention(q, k, v, no_max=False)
        rect = tfa.flash_attention_rect(q[:, :, :40], k, v, no_max=False,
                                        kv_valid=100)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jfa.flash_attention(*qkv, no_max=False)),
        **TOL_O)
    np.testing.assert_allclose(
        rect.numpy(), np.asarray(jfa.flash_attention_rect(
            qkv[0][:, :, :40], qkv[1], qkv[2], no_max=False, kv_valid=100)),
        **TOL_O)
    q = torch.zeros((1, 2, 129, 80))
    for kv in (0, 130):
        with pytest.raises(ValueError, match="kv_valid"):
            tfa.flash_attention_rect(q, q, q, kv_valid=kv)
    with pytest.raises(ValueError, match="CUDA"):  # host pointers never reach it
        tfa.fwd_bh_cuda(q, q, q, None, None, 0.1)


def test_kernel_stride_array_of_fused_buffer_views():
    """The stride array the [B, H, N, D] kernels read: (batch, head, row)
    of each operand, in elements; for the views of a fused buffer the
    batch stride is N*3*H*D, the head stride D and the row stride 3*H*D."""
    x, _ = _data(2, 9, 3, 80)
    _, (q, k, v) = _torch_qkv(x)
    arr = tfa._strides(q, k, v, tfa._empty_like_rows(q))
    assert list(arr) == [9 * 720, 80, 720] * 3 + [9 * 240, 80, 240]
