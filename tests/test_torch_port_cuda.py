"""B1-B8 on the card against their plain versions, at small ragged
shapes; the bf16 Hopper forward body (B1, B3, B5) at each head_dim it
serves, with the cls fold, the rect form and large logits, run twice.

Needs an NVIDIA card (marker ``cuda``); skips without one.  Imports no
JAX, so it runs on a machine that has only PyTorch, without the JAX
platform setup of tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_port_cuda.py

Tolerances are chip_smoke.py's: fp32 o at 5e-5; bf16 o within two bf16
rounding steps (|d| <= 2^-8 + 2^-6 |o|); lse at 1e-4.  B2's gradients:
fp32 at 5e-4 relative to the largest gradient (sums of up to n terms in
another order); bf16 at 2^-7 relative (each output is rounded to bf16 on
both sides, and p and ds are rounded to bf16 before their products, so a
score whose fp32 value differs in the last bit may round the other way:
one bf16 step of the largest gradient, 2^-8, twice over).  The bf16
backward at head_dim <= 128 sums dq in fp32 across blocks in varying
order: dq is held within that tolerance on two runs, dk, dv, dkc and dvc
bit-identical between them.

B6 (the exact softmax) at the same o / lse limits, with logits x 8 far
above the fixed shift's clamp; on the Hopper body (bf16, D <= 128) also
at q x 40 and twice, bit-identical, its large-logit o within 2^-8 of
max|v| (p is rounded against the running max).  B8 (the ablation
variants, every one at every tile) within 2^-7 of the largest plain
output in bf16 (a stripped variant's outputs have no softmax scale; p is
rounded to bf16 on both sides), its raw l within 1e-4 of the largest.

The MAE's remat twin launches B1 twice per block and B2 once, with the
plain graph's loss and its gradients within chip_smoke.py's run-to-run
limit; a
TrainState on the card survives an async checkpoint bit for bit.

B1's custom op (the serving forward) launches B1 on the card and equals
its CPU implementation, the plain version, to the B1 tolerances; the
card's int8 GEMM refuses the shapes it cannot take and equals the CPU's
int32 product; an AOT artifact round trip on the card equals the live
model and launches one B1 per block.

Batch 2 throughout, and the cls-fold dO is the [:, 1:] slice of a
[B, m + 1, H*D] buffer, as autograd hands it over after the cls row's
concat: the kernels' batch strides are exercised.  B3-B5 and B7 take
the [B, H, N, D] views of the fused buffer (head stride D, row stride
3*H*D), as the packed path's reroute hands them over.
"""

import pytest
import torch

from octcubem_tpu_torch.ops import _cuda
from octcubem_tpu_torch.ops import flash_attention as fa
from octcubem_tpu_torch.ops.attention import naive_attention
from octcubem_tpu_torch.scripts import kablate

pytestmark = pytest.mark.cuda

TOL_O = {torch.float32: (5e-5, 0.0), torch.bfloat16: (2 ** -8, 2 ** -6)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, n, h, d, dtype, qmul=1.0):
    x = torch.randn((2, n, 3 * h * d), generator=gen, device="cuda")
    x[..., :h * d] *= qmul
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h,d,qmul", [
    (1, 2, 64, 1.0), (65, 2, 32, 1.0), (129, 4, 32, 1.0), (200, 2, 64, 1.0),
    (257, 1, 128, 1.0), (129, 1, 256, 1.0), (300, 2, 64, 40.0)])
def test_kernel_matches_plain(gen, n, h, d, qmul, dtype):
    qkv = _qkv(gen, n, h, d, dtype, qmul)
    hd = h * d
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    for args in ((q, k, v, None, None),
                 (q[:, 1:], k[:, 1:], v[:, 1:], k[:, :1], v[:, :1])):
        if args[0].shape[1] == 0:
            continue
        o, lse = fa.fwd_packed_cuda(*args, h, d ** -0.5)
        o_ref, lse_ref = fa.fwd_packed_plain(*args, h, d ** -0.5)
        atol, rtol = TOL_O[dtype]
        torch.testing.assert_close(o.float(), o_ref.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)


def test_public_path_counts_launches(gen):
    qkv = _qkv(gen, 129, 2, 64, torch.bfloat16)
    before = _cuda.launches["flash_fwd_packed"]
    out = fa.flash_attention_packed_qkv(qkv, 2)
    ref = fa.flash_attention_packed_qkv(qkv.cpu(), 2)
    assert _cuda.launches["flash_fwd_packed"] == before + 1
    torch.testing.assert_close(out.cpu().float(), ref.float(),
                               atol=2 ** -8, rtol=2 ** -6)


TOL_GRAD = {torch.float32: 5e-4, torch.bfloat16: 2 ** -7}


def _assert_grad_close(got, ref, dtype, what):
    """|got - ref| <= tol * max|ref| (see the module docstring)."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    assert err <= TOL_GRAD[dtype] * max(scale, 1e-6), (what, err, scale)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h,d,qmul", [
    (65, 4, 32, 1.0), (129, 4, 32, 1.0), (200, 2, 64, 1.0), (257, 1, 128, 1.0),
    (129, 1, 256, 1.0), (300, 2, 64, 40.0)])
def test_bwd_kernel_matches_plain(gen, n, h, d, qmul, dtype):
    qkv = _qkv(gen, n, h, d, dtype, qmul)
    hd, scale = h * d, d ** -0.5
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    for args in ((q, k, v, None, None),
                 (q[:, 1:], k[:, 1:], v[:, 1:], k[:, :1], v[:, :1])):
        o, lse = fa.fwd_packed_plain(*args, h, scale)
        do = torch.randn((2, n, hd), generator=gen, device="cuda").to(dtype)
        do = do[:, 1:] if args[3] is not None else do
        g_lse = 0.1 * torch.randn(lse.shape, generator=gen, device="cuda")
        got = fa.bwd_packed_cuda(*args, o, lse, do, g_lse, h, scale)
        ref = fa.bwd_packed_plain(*args, o, lse, do, g_lse, h, scale)
        for name, a, b in zip(("dq", "dk", "dv", "dkc", "dvc"), got, ref):
            if b is None:
                assert a is None
                continue
            assert a.dtype == dtype and torch.isfinite(a.float()).all()
            _assert_grad_close(a, b, dtype, name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [129, 200])
def test_qkv_grad_on_card_matches_cpu(gen, n, dtype):
    """qkv.grad through B1 + B2 on the card against the CPU plain path,
    and one B2 launch counted per backward."""
    qkv = _qkv(gen, n, 2, 64, dtype)
    g = torch.randn((2, n, 128), generator=gen, device="cuda").to(dtype)
    x = qkv.clone().requires_grad_()
    before = _cuda.launches["flash_bwd_packed"]
    fa.flash_attention_packed_qkv(x, 2).backward(g)
    assert _cuda.launches["flash_bwd_packed"] == before + 1
    xc = qkv.cpu().requires_grad_()
    fa.flash_attention_packed_qkv(xc, 2).backward(g.cpu())
    _assert_grad_close(x.grad.cpu(), xc.grad, dtype, "dqkv")


def test_cuda_path_refuses_what_it_does_not_serve(gen):
    qkv = _qkv(gen, 129, 2, 64, torch.float32)
    with pytest.raises(ValueError):
        fa.flash_attention_packed_qkv(qkv.half(), 2)
    hd = 128
    args = (qkv[:, 1:, :hd], qkv[:, 1:, hd:2 * hd], qkv[:, 1:, 2 * hd:],
            qkv[:, :1, hd:2 * hd], qkv[:, :1, 2 * hd:])
    o, lse = fa.fwd_packed_cuda(*args, 2, 0.125)
    with pytest.raises(ValueError, match="dO"):
        fa.bwd_packed_cuda(*args, o, lse, o[:, 1:], None, 2, 0.125)


# the bf16 Hopper forward body (B1, B3, B5 at D <= 128): (route, D, case)
HOPPER_FWD = [(r, d, c) for d in (32, 64, 80, 128)
              for c in ("ragged", "cls", "large-logit cls", "rect")
              for r in ("bh", "packed")
              if r == "bh" or (d in fa.HEAD_DIMS and c != "rect")]


@pytest.mark.parametrize("route,d,case", HOPPER_FWD)
def test_hopper_fwd_matches_plain_and_repeats(gen, route, d, case):
    """333 query rows and keys (no multiple of the 128-row and 128-key
    tiles) without the cls fold, 333 + cls with it, q x 40 with it, and
    the rect form (200 query rows, 300 keys, kv_valid 259, NaN in k and v
    past it), on the packed route (column views of the fused buffer) and
    the [B, H, N, D] views; each call made twice, o and lse
    bit-identical (the forward has no atomics)."""
    dtype, h, scale, kv = torch.bfloat16, 2, d ** -0.5, None
    if case == "rect":
        q = torch.randn((2, h, 200, d), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((2, h, 300, d), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        kv = 259
        k[:, :, kv:], v[:, :, kv:] = float("nan"), float("nan")
        args = (q, k, v, None, None)
    else:
        cls = case != "ragged"
        qkv = _qkv(gen, 333 + cls, h, d, dtype,
                   40.0 if case.startswith("large") else 1.0)
        if route == "packed":
            args = fa._split_qkv(qkv, cls)
        else:
            q, k, v = _bh_views(qkv, h, d)
            args = ((q[:, :, 1:], k[:, :, 1:], v[:, :, 1:], k[:, :, :1],
                     v[:, :, :1]) if cls else (q, k, v, None, None))
    if route == "packed":
        first, second = (fa.fwd_packed_cuda(*args, h, scale) for _ in range(2))
        o_ref, lse_ref = fa.fwd_packed_plain(*args, h, scale)
    else:
        first, second = (fa.fwd_bh_cuda(*args, scale, kv) for _ in range(2))
        o_ref, lse_ref = fa.fwd_bh_plain(*args, scale, kv)
    atol, rtol = TOL_O[dtype]
    for o, lse in (first, second):
        torch.testing.assert_close(o.float(), o_ref.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_fwd_copies_views_a_tensor_map_cannot_take(gen):
    """Views off the 16-byte grid (a contiguous view 2 elements into its
    storage, a column view 8 bytes off) reach the forward kernels through a
    copy and match the plain version."""
    h, d, n = 2, 64, 200
    x = torch.randn((2 * n * 3 * h * d + 2,), generator=gen, device="cuda")
    qkv = x.to(torch.bfloat16)[2:].view(2, n, 3 * h * d)
    args = fa._split_qkv(qkv, True)
    o, lse = fa.fwd_packed_cuda(*args, h, d ** -0.5)
    o_ref, lse_ref = fa.fwd_packed_plain(*args, h, d ** -0.5)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2 ** -8,
                               rtol=2 ** -6)
    q, k, v = _bh_views(qkv, h, d)
    args = (q[:, :, 1:], k[:, :, 1:], v[:, :, 1:], k[:, :, :1], v[:, :, :1])
    o, lse = fa.fwd_bh_cuda(*args, d ** -0.5)
    o_ref, lse_ref = fa.fwd_bh_plain(*args, d ** -0.5)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2 ** -8,
                               rtol=2 ** -6)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)


# ------------------------------------------------- [B, H, N, D]: B3-B5, B7

def _bh_views(qkv, h, d):
    """q, k, v [B, H, N, D] views of a fused [B, N, 3*H*D] buffer."""
    b, n, _ = qkv.shape
    return [qkv[..., i * h * d:(i + 1) * h * d].view(b, n, h, d).transpose(1, 2)
            for i in range(3)]


def _check_bh(args, h, d, dtype, gen, kv_valid=None, no_max=True):
    """B3 / B5 (forward) and B4 / B7 (backward) against their plain
    versions on the same inputs; the backward on the plain forward's
    (o, lse), with a strided dO and a nonzero g_lse."""
    q = args[0]
    scale = d ** -0.5
    if no_max:
        o, lse = fa.fwd_bh_cuda(*args, scale, kv_valid)
        o_ref, lse_ref = fa.fwd_bh_plain(*args, scale, kv_valid)
        atol, rtol = TOL_O[dtype]
        torch.testing.assert_close(o.float(), o_ref.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
        # laid out as q is: heads inside rows for the fused buffer's views
        assert o.transpose(1, 2).is_contiguous() == (q.stride(1) < q.stride(2))
    else:  # the exact softmax's (o, lse)
        k, v = args[1][:, :, :kv_valid], args[2][:, :, :kv_valid]
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
        lse_ref = torch.logsumexp(s, dim=-1)
        o_ref = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1),
                             v.float()).to(dtype)
    b, hh, nq, _ = q.shape
    do = torch.randn((b, nq + 1, hh, d), generator=gen, device="cuda")
    do = do.to(dtype)[:, 1:].transpose(1, 2)  # strided, as autograd's
    g_lse = 0.1 * torch.randn(lse_ref.shape, generator=gen, device="cuda")
    got = fa.bwd_bh_cuda(*args, o_ref, lse_ref, do, g_lse, scale, no_max,
                         kv_valid)
    ref = fa.bwd_bh_plain(*args, o_ref, lse_ref, do, g_lse, scale, no_max,
                          kv_valid)
    for name, a, r in zip(("dq", "dk", "dv", "dkc", "dvc"), got, ref):
        if r is None:
            assert a is None
            continue
        assert a.dtype == dtype and torch.isfinite(a.float()).all()
        _assert_grad_close(a, r, dtype, name)
    if kv_valid is not None:
        assert (got[1][:, :, kv_valid:] == 0).all()
        assert (got[2][:, :, kv_valid:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h,d,qmul", [
    (129, 2, 80, 1.0), (200, 2, 80, 1.0), (65, 4, 32, 1.0), (257, 1, 128, 1.0),
    (129, 1, 256, 1.0), (300, 2, 64, 1.0), (257, 2, 80, 40.0)])
def test_bh_kernels_match_plain(gen, n, h, d, qmul, dtype):
    """B5 / B7 over all n rows, and B3 / B4 over rows 1: with row 0 as the
    cls key/value."""
    qkv = _qkv(gen, n, h, d, dtype, qmul)
    q, k, v = _bh_views(qkv, h, d)
    _check_bh((q, k, v, None, None), h, d, dtype, gen)
    _check_bh((q[:, :, 1:], k[:, :, 1:], v[:, :, 1:], k[:, :, :1],
               v[:, :, :1]), h, d, dtype, gen)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nq,nk,kv_valid,no_max", [
    (70, 260, 250, True), (300, 129, 129, True), (100, 200, 190, False)])
def test_bh_rect_and_exact_backward_match_plain(gen, nq, nk, kv_valid, no_max,
                                                dtype):
    """Nq != Nk with kv_valid (dk = dv = 0 past it), and B7's no_max=False
    branch on the exact softmax's lse, at head_dim 80; contiguous
    [B, H, N, D] tensors."""
    h, d = 2, 80
    q = torch.randn((2, h, nq, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((2, h, nk, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    _check_bh((q, k, v, None, None), h, d, dtype, gen, kv_valid, no_max)


@pytest.mark.parametrize("nq,nk,kv_valid,h,d,cls", [
    (70, 200, 190, 2, 32, True), (130, 300, 300, 2, 64, False),
    (100, 250, 201, 2, 80, True), (77, 129, 129, 1, 128, False),
    (200, 333, 333, 2, 80, False)])
def test_bf16_one_pass_ragged_and_run_to_run(gen, nq, nk, kv_valid, h, d,
                                             cls):
    """The bf16 one-pass body at each of its head dims, nq not a multiple
    of the query tile and the key count not a multiple of the 128-key
    tile, called twice on the same inputs: dk, dv, dkc and dvc are
    bit-identical, dq (fp32 adds in varying order) within tolerance on
    both runs."""
    dtype = torch.bfloat16
    q = torch.randn((2, h, nq, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((2, h, nk, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    kc, vc = ((torch.randn((2, h, 1, d), generator=gen, device="cuda")
               .to(dtype) for _ in range(2)) if cls else (None, None))
    if cls:  # kc / vc must share k's / v's batch and head strides
        k, v = (torch.cat([c, t], 2) for c, t in ((kc, k), (vc, v)))
        kc, vc, k, v = k[:, :, :1], v[:, :, :1], k[:, :, 1:], v[:, :, 1:]
    kv = kv_valid if kv_valid < nk else None
    scale = d ** -0.5
    o, lse = fa.fwd_bh_plain(q, k, v, kc, vc, scale, kv)
    do = torch.randn((2, nq, h, d), generator=gen, device="cuda").to(dtype)
    do = do.transpose(1, 2)
    g_lse = 0.1 * torch.randn(lse.shape, generator=gen, device="cuda")
    args = (q, k, v, kc, vc, o, lse, do, g_lse, scale, True, kv)
    first, second = fa.bwd_bh_cuda(*args), fa.bwd_bh_cuda(*args)
    ref = fa.bwd_bh_plain(*args)
    for name, a, b, r in zip(("dq", "dk", "dv", "dkc", "dvc"), first, second,
                             ref):
        if r is None:
            assert a is None and b is None
            continue
        if name != "dq":
            assert torch.equal(a, b), name
        for got in (a, b):
            assert torch.isfinite(got.float()).all()
            _assert_grad_close(got, r, dtype, name)
    if kv is not None:
        assert (first[1][:, :, kv:] == 0).all()
        assert (first[2][:, :, kv:] == 0).all()


def test_bh_public_path_counts_launches(gen):
    """The packed path at head_dim 80 launches B3 / B4 (cls-prefixed n) or
    B5 / B7, never B1 / B2, and qkv.grad matches the CPU plain path."""
    for n, fwd, bwd in ((129, "flash_fwd_bh_cls", "flash_bwd_bh_cls"),
                        (200, "flash_fwd_bh", "flash_bwd_bh")):
        qkv = _qkv(gen, n, 2, 80, torch.bfloat16)
        g = torch.randn((2, n, 160), generator=gen, device="cuda").to(qkv.dtype)
        _cuda.reset_launches()
        x = qkv.clone().requires_grad_()
        fa.flash_attention_packed_qkv(x, 2).backward(g)
        assert {k: c for k, c in _cuda.launches.items() if c} == {fwd: 1,
                                                                   bwd: 1}
        xc = qkv.cpu().requires_grad_()
        fa.flash_attention_packed_qkv(xc, 2).backward(g.cpu())
        _assert_grad_close(x.grad.cpu(), xc.grad, torch.bfloat16, "dqkv")


def test_bh_refuses_what_it_does_not_serve(gen):
    q = torch.randn((1, 2, 64, 48), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.fwd_bh_cuda(q, q, q, None, None, 0.1)
    q = torch.randn((1, 2, 64, 80), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="kv_valid"):
        fa.fwd_bh_cuda(q, q, q, None, None, 0.1, kv_valid=65)
    with pytest.raises(ValueError, match="dtype"):
        fa.fwd_bh_cuda(q.half(), q.half(), q.half(), None, None, 0.1)


# ------------------------------------------------------ B6: exact softmax

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nq,nk,kv_valid,h,d,qmul", [
    (200, 200, None, 2, 32, 1.0), (129, 129, None, 2, 80, 8.0),
    (300, 300, None, 2, 64, 8.0), (257, 257, None, 1, 128, 1.0),
    (129, 129, None, 1, 256, 8.0), (70, 260, 250, 2, 80, 8.0),
    (100, 513, 500, 4, 32, 1.0)])
def test_b6_matches_plain(gen, nq, nk, kv_valid, h, d, qmul, dtype):
    """B6 against fwd_bh_exact_plain: square on the fused buffer's
    [B, H, N, D] views, rect (Nq != Nk, kv_valid) on contiguous tensors;
    at x 8 B6 agrees with naive attention, where B5 cannot."""
    scale = d ** -0.5
    if nq == nk:
        q, k, v = _bh_views(_qkv(gen, nq, h, d, dtype, qmul), h, d)
    else:
        q = (qmul * torch.randn((2, h, nq, d), generator=gen,
                                device="cuda")).to(dtype)
        k, v = (torch.randn((2, h, nk, d), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
    o, lse = fa.fwd_bh_cuda(q, k, v, None, None, scale, kv_valid, no_max=False)
    o_ref, lse_ref = fa.fwd_bh_exact_plain(q, k, v, scale, kv_valid)
    atol, rtol = TOL_O[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    if qmul > 1.0 and dtype == torch.float32:
        kk, vv = k[:, :, :kv_valid], v[:, :, :kv_valid]
        torch.testing.assert_close(o, naive_attention(q, kk, vv), atol=atol,
                                   rtol=rtol)


def test_b6_public_path_counts_launches(gen):
    """flash_attention(no_max=False) launches B6 / B7 (no cls split at
    n = 129); the packed API's no_max=False reaches the same kernels; q,
    k, v gradients match the CPU plain path."""
    qkv = _qkv(gen, 129, 2, 80, torch.bfloat16, 8.0)
    g = torch.randn((2, 129, 160), generator=gen, device="cuda").to(qkv.dtype)
    _cuda.reset_launches()
    x = qkv.clone().requires_grad_()
    fa.flash_attention_packed_qkv(x, 2, no_max=False).backward(g)
    assert {k: c for k, c in _cuda.launches.items() if c} == {
        "flash_fwd_bh_exact": 1, "flash_bwd_bh": 1}
    xc = qkv.cpu().requires_grad_()
    fa.flash_attention_packed_qkv(xc, 2, no_max=False).backward(g.cpu())
    _assert_grad_close(x.grad.cpu(), xc.grad, torch.bfloat16, "dqkv")


# B6 in bf16 on the Hopper body (D <= 128): (D, case)
HOPPER_B6 = [(d, c) for d in (32, 64, 80, 128)
             for c in ("ragged", "x8", "x40", "rect")]


@pytest.mark.parametrize("d,case", HOPPER_B6)
def test_b6_hopper_matches_plain_and_repeats(gen, d, case):
    """B6 in bf16 on the Hopper body: 333 query rows and keys (no multiple
    of the 128-row and 128-key tiles) on the fused buffer's [B, H, N, D]
    views, with q and k x 8 (logits x 64) and with q x 40, and the rect
    form (200 query rows, 300 keys, kv_valid 259, NaN in k and v past it
    for the forward); each call made twice, o and lse bit-identical; B6 +
    B7 under autograd (finite tails) against the plain versions.  At large
    logits a few keys carry each row and the kernel rounds p against its
    running max, so o may differ from the plain version by 2^-8 of
    max|v| on top of o's own rounding (chip_smoke.py's limit); and there
    the gradient of a key that carries a row is a difference of nearly
    equal o and v, so o's last bit moves it by about TOL_GRAD: the plain
    backward on the two forwards' outputs differs by up to 1.4 TOL_GRAD
    for either forward body, the mma.sync one or this one (PERF.md).  So
    at large logits the autograd gradients are held against the plain
    backward on the kernel's own (o, lse), which holds B7 and the units of
    B6's lse, while o itself is held to the plain forward above."""
    dtype, h, scale, kv = torch.bfloat16, 2, d ** -0.5, None
    qmul, kmul = {"x8": (8.0, 8.0), "x40": (40.0, 1.0)}.get(case, (1.0, 1.0))
    if case == "rect":
        q = torch.randn((2, h, 200, d), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((2, h, 300, d), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        kv = 259
        kn, vn = k.clone(), v.clone()
        kn[:, :, kv:], vn[:, :, kv:] = float("nan"), float("nan")
    else:
        x = torch.randn((2, 333, 3 * h * d), generator=gen, device="cuda")
        x[..., :h * d] *= qmul
        x[..., h * d:2 * h * d] *= kmul
        q, k, v = _bh_views(x.to(dtype), h, d)
        kn, vn = k, v
    first, second = (fa.fwd_bh_cuda(q, kn, vn, None, None, scale, kv, False)
                     for _ in range(2))
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    o, lse = first
    o_ref, lse_ref = fa.fwd_bh_exact_plain(q, k, v, scale, kv)
    atol, rtol = TOL_O[dtype]
    if qmul * kmul > 1.0:
        atol = 2 ** -8 * v.float().abs().max().item()
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
    # lse at TOL 1e-4, or 8 fp32 ulps of its size at large logits
    tol_lse = max(1e-4, 8 * 2 ** -23 * lse_ref.abs().max().item())
    torch.testing.assert_close(lse, lse_ref, atol=tol_lse, rtol=0)
    g = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_rect(*ts, scale, False, kv)
    grads = torch.autograd.grad(out, ts, g)
    if qmul * kmul > 1.0:
        o_ref, lse_ref = o, lse
    ref = fa.bwd_bh_plain(q, k, v, None, None, o_ref, lse_ref, g, None, scale,
                          False, kv)
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
        assert torch.isfinite(a.float()).all()
        _assert_grad_close(a, r, dtype, name)


# -------------------------------------------------- B8: ablation variants

@pytest.mark.parametrize("variant,tile", [
    (v, t) for t in ("f128x128", "f128x64", "f64x128", "f64x64")
    for v in ("base", "noexp", "nosum", "qkonly", "mxonly", "mxbf16")])
def test_b8_matches_plain(gen, variant, tile):
    """Every flag variant at every tile of the Hopper body, each at its own
    padding."""
    flags = kablate.VARIANTS[variant]
    q, k, v = (torch.randn((2, 200, 32), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    before = _cuda.launches["flash_ablate"]
    o, lse = kablate.fwd_variant(q, k, v, tile, **flags)
    assert _cuda.launches["flash_ablate"] == before + 1
    o_ref, lse_ref = kablate.fwd_variant_plain(
        q, k, v, kablate.n_pad_of(200, tile), kablate.TILES[tile][2], **flags)
    err = (o.float() - o_ref.float()).abs().max().item()
    assert err <= 2 ** -7 * o_ref.float().abs().max().item(), err
    lerr = (lse - lse_ref).abs().max().item()
    assert lerr <= 1e-4 * max(lse_ref.abs().max().item(), 1e-30), lerr


# ------------------------------- remat and checkpoints of the MAE step

def _tiny_mae(**kw):
    """A small bf16 MAE on the card: 2 + 1 blocks, head_dim 64 / 32, the
    encoder at 13 tokens and the decoder at 129 (B1 + B2 throughout)."""
    from octcubem_tpu_torch.models import mae3d

    return mae3d.create_model(
        mae3d.MaskedAutoencoderViT3D, device="cuda", seed=1, input_size=64,
        high_res_input_size=128, patch_size=16, in_chans=1, embed_dim=128,
        depth=2, num_heads=2, decoder_embed_dim=128, decoder_depth=1,
        decoder_num_heads=4, num_frames=24, t_patch_size=3, pred_t_dim=24,
        dtype=torch.bfloat16, **kw)


def test_remat_recomputes_b1(gen):
    """A remat twin launches B1 twice per block (forward and recompute)
    and B2 once; its loss equals the plain graph's and its gradients agree
    within B2's bf16 limit, 2^-7 of each leaf's largest (B2's dq, summed
    in varying order, differs in bf16 ulps that pass through the blocks
    below)."""
    model = _tiny_mae(drop_path_rate=0.2)
    twin = model.with_remat()
    x = torch.randn((2, 24, 64, 64, 1), generator=gen, device="cuda")
    noise = torch.rand((2, 128), generator=gen, device="cuda")
    out = []
    for m in (model, twin):
        g = torch.Generator(device="cuda").manual_seed(3)
        _cuda.reset_launches()
        loss = m(x, 0.9, noise, generator=g)[0]
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
        torch.cuda.synchronize()
        out.append((loss.item(), grads, dict(_cuda.launches)))
    (l0, g0, n0), (l1, g1, n1) = out
    assert n0["flash_fwd_packed"] == 3 and n0["flash_bwd_packed"] == 3
    assert n1["flash_fwd_packed"] == 6 and n1["flash_bwd_packed"] == 3
    assert l0 == l1
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            top = max(a.abs().max().item(), 1e-30)
            assert (a - b).abs().max().item() <= TOL_GRAD[torch.bfloat16] * top


def test_train_state_round_trip_on_card(gen, tmp_path):
    """A TrainState on the card (bf16 mu, a CUDA generator) saved async
    after a pre-masked step and restored into a fresh state: bit-identical;
    the next step's loss equal from both."""
    from octcubem_tpu_torch.core import checkpoint
    from octcubem_tpu_torch.train import mae_engine, optim
    from octcubem_tpu_torch.train.train_state import TrainState

    x = torch.randn((2, 24, 64, 64, 1), generator=gen, device="cuda")

    def build():
        model = _tiny_mae()
        tx = optim.build_fused_adamw(model, 1e-3, mu_dtype=torch.bfloat16)
        return (TrainState.create(model, tx, seed=2),
                mae_engine.make_mae_train_step(model, tx, use_premask=True))

    live, step = build()
    live, _ = step(live, x, 0.9)
    checkpoint.save_checkpoint(str(tmp_path), live.step, live, async_save=True)
    fresh, fstep = build()
    checkpoint.restore_checkpoint(str(tmp_path), fresh)
    assert fresh.step == live.step == 1 and fresh.tx.count == 1
    assert torch.equal(fresh.generator.get_state(), live.generator.get_state())
    pa, pb = live.params.state_dict(), fresh.params.state_dict()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert all(u.dtype == v.dtype and torch.equal(u, v) for u, v in
               zip(live.tx.mu + live.tx.nu, fresh.tx.mu + fresh.tx.nu))
    assert step(live, x, 0.9)[1]["loss"].item() == \
        fstep(fresh, x, 0.9)[1]["loss"].item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [129, 200])
def test_flash_op_cuda_matches_its_cpu_implementation(gen, dtype, n):
    """octcubem_tpu_torch::flash_fwd_packed_qkv: its CUDA implementation
    (one B1 launch) against its CPU one (the plain version) on the same
    inputs, with (n = 129) and without (n = 200) the cls fold."""
    h, d = 4, 64
    qkv = torch.randn((2, n, 3 * h * d), generator=gen,
                      device="cuda").to(dtype)
    cls = fa._cls_split(n)
    _cuda.reset_launches()
    o, lse = fa.flash_fwd_packed_qkv_op(qkv, h, d ** -0.5, cls)
    torch.cuda.synchronize()
    assert _cuda.launches["flash_fwd_packed"] == 1
    o_ref, lse_ref = fa.flash_fwd_packed_qkv_op(qkv.cpu(), h, d ** -0.5, cls)
    assert o.shape == (2, n - cls, h * d) and lse.shape == (2, h, n - cls)
    atol, rtol = TOL_O[dtype]
    torch.testing.assert_close(o.float().cpu(), o_ref.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse.cpu(), lse_ref, atol=1e-4, rtol=0)
    with torch.no_grad():  # the serving path goes through the op
        _cuda.reset_launches()
        fa.flash_attention_packed_qkv(qkv, h)
        assert _cuda.launches["flash_fwd_packed"] == 1


def test_int_mm_shape_guard(gen):
    """torch._int_mm on the card takes M > 16 and K, N multiples of 8: the
    wrapper refuses the rest by name; what it takes equals the CPU's
    int32 product, and int8_matmul equals the CPU's to an fp32 ulp."""
    from octcubem_tpu_torch.ops import quant

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    for m, k, n in ((16, 64, 64), (64, 60, 64), (64, 64, 60)):
        with pytest.raises(ValueError, match="M > 16 rows and K, N"):
            quant.int8_mm(i8(m, k), i8(n, k))
    for m, k, n in ((17, 64, 64), (4097, 1024, 3072), (300, 4096, 1024)):
        a, w = i8(m, k), i8(n, k)
        got = quant.int8_mm(a, w)
        assert got.dtype == torch.int32 and got.is_cuda
        assert torch.equal(got.cpu(), quant.int8_mm(a.cpu(), w.cpu()))
    x = torch.randn((2, 33, 256), generator=gen, device="cuda")
    wq, ws = quant.quantize_weight(torch.randn((512, 256), generator=gen,
                                               device="cuda"))
    torch.testing.assert_close(quant.int8_matmul(x, wq, ws).cpu(),
                               quant.int8_matmul(x.cpu(), wq.cpu(),
                                                 ws.cpu()),
                               rtol=1e-6, atol=0)


def test_aot_round_trip_on_card(gen, tmp_path):
    """A narrow classifier exported on the card, written, loaded: one B1 op
    call and one B1 launch per block, the live logits; exported on the CPU
    for both platforms, it runs on the card the same way."""
    from octcubem_tpu_torch.compat import aot
    from octcubem_tpu_torch.models import vit_st

    kw = dict(num_frames=6, t_patch_size=3, img_size=64, in_chans=1,
              num_classes=4, embed_dim=128, depth=2, num_heads=2,
              head_type="dropout", dtype=torch.bfloat16)
    model = vit_st.create_model(vit_st.VisionTransformerST, seed=1, **kw)
    x = torch.rand((1, 6, 64, 64, 1), generator=gen, device="cuda")
    with torch.inference_mode():
        live = model(x)
    path = aot.export_serving_artifact(model, (x,), str(tmp_path / "a"))
    cpu_model = vit_st.create_model(vit_st.VisionTransformerST, seed=1,
                                    device="cpu", **kw)
    cpu_model.load_state_dict(model.state_dict())
    both = aot.export_serving_artifact(cpu_model, (x.cpu(),),
                                       str(tmp_path / "b"),
                                       platforms=("cuda", "cpu"))
    for p in (path, both):
        fn, meta = aot.load_serving_artifact(p)
        assert aot.flash_op_calls(fn.program) == 2
        _cuda.reset_launches()
        out = fn(x)
        torch.cuda.synchronize()
        assert _cuda.launches["flash_fwd_packed"] == 2
        assert out.is_cuda and torch.equal(out, live), meta["exported_on"]
    with pytest.raises(ValueError, match="exported for"):
        aot.load_serving_artifact(aot.export_serving_artifact(
            cpu_model, (x.cpu(),), str(tmp_path / "c")))


def test_finetune_step_launches_b1_b2_per_block_and_reads_nothing_back(gen):
    """One fine-tune step (train/finetune_engine.py) on a small ViT-ST at a
    cls-prefixed 129 tokens, drop path 0.2, the layer-decay AdamW gated on
    the device: one B1 and one B2 launch per block and no other attention
    kernel; a NaN batch leaves params, moments and count as they were;
    the step's trace holds no device-to-host copy."""
    from octcubem_tpu_torch.models import vit_st
    from octcubem_tpu_torch.train import finetune_engine, losses, optim
    from octcubem_tpu_torch.train.train_state import TrainState

    model = vit_st.create_model(
        vit_st.VisionTransformerST, device="cuda", num_frames=6,
        t_patch_size=3, img_size=128, in_chans=1, num_classes=6,
        embed_dim=128, depth=3, num_heads=2, drop_path_rate=0.2,
        dtype=torch.bfloat16)
    tx = optim.build_adamw(model, 1e-3, 0.05, layer_decay=0.65,
                           num_blocks=3, name_prefix="params.")
    state = TrainState.create(model, tx, 1)
    step = finetune_engine.make_finetune_train_step(
        model, tx, losses.make_criterion("multi_task_default"))
    x = torch.randn((2, 6, 128, 128, 1), generator=gen, device="cuda")
    y = torch.tensor([[0, 1, 0, 1], [1, 0, 0, 0]], dtype=torch.float32,
                     device="cuda")
    _cuda.reset_launches()
    state, m = step(state, x, y)
    torch.cuda.synchronize()
    assert {k: c for k, c in _cuda.launches.items() if c} == {
        "flash_fwd_packed": 3, "flash_bwd_packed": 3}
    assert bool(m["finite"])
    before = [p.detach().clone() for p in model.parameters()]
    mu = [t.clone() for t in tx.mu]
    count = tx.count.clone()
    bad = x.clone()
    bad[0, 0, 0, 0, 0] = float("nan")
    state, m = step(state, bad, y)
    assert not bool(m["finite"])
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(mu, tx.mu))
    assert torch.equal(count, tx.count)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, m = step(state, x, y)
        torch.cuda.synchronize()
    dtoh = [e.name for e in prof.events()
            if "DtoH" in e.name or "Device -> Host" in e.name]
    assert dtoh == []
