"""B1 and B2 on the card against their plain versions, at small ragged
shapes.

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
one bf16 step of the largest gradient, 2^-8, twice over).

Batch 2 throughout, and the cls-fold dO is the [:, 1:] slice of a
[B, m + 1, H*D] buffer, as autograd hands it over after the cls row's
concat: the kernels' batch strides are exercised.
"""

import pytest
import torch

from octcubem_tpu_torch.ops import _cuda
from octcubem_tpu_torch.ops import flash_attention as fa

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
