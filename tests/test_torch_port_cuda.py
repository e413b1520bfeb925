"""B1 on the card against its plain version, at small ragged shapes.

Needs an NVIDIA card (marker ``cuda``); skips without one.  Imports no
JAX, so it runs on a machine that has only PyTorch, without the JAX
platform setup of tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_port_cuda.py

Tolerances are chip_smoke.py's: fp32 o at 5e-5; bf16 o within two bf16
rounding steps (|d| <= 2^-8 + 2^-6 |o|); lse at 1e-4.
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


def test_cuda_path_refuses_what_it_does_not_serve(gen):
    qkv = _qkv(gen, 129, 2, 64, torch.float32).requires_grad_()
    with pytest.raises(NotImplementedError, match="B2"):
        fa.flash_attention_packed_qkv(qkv, 2)
    with pytest.raises(ValueError):
        fa.flash_attention_packed_qkv(qkv.detach().half(), 2)
