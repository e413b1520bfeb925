"""The bf16 backward's wrapper rules, on CPU tensors (plain Python on
shapes and strides, so they hold here as on the card):

- which q, k, v and dO views a TMA tensor map describes as they are
  (``_for_tma``: a 16-byte aligned base, strides that are multiples of 16
  bytes, unit stride along D), and which are copied first;
- the shape of the fp32 dq accumulator the one-pass body adds into
  (``dq_accum_shape``): [B, H, nq rounded up to 128 rows, D] for bf16 at
  head_dim <= 128, none for the CUDA-core passes.

At the ViT-L, ViT-H and rect (4-shard) shapes, as the paths lay them out.
"""

import pytest
import torch

from octcubem_tpu_torch.ops import flash_attention as fa


def _fused(b, n, h, d):
    return torch.zeros((b, n, 3 * h * d), dtype=torch.bfloat16)


def _bh_views(qkv, h):
    b, n, hd3 = qkv.shape
    return [t.transpose(1, 2)
            for t in qkv.view(b, n, 3, h, hd3 // (3 * h)).unbind(2)]


@pytest.mark.parametrize("b,n,h,d", [
    (1, 4097, 16, 64),   # ViT-L forward / serving
    (4, 5121, 16, 32),   # ViT-L MAE decoder, 16 heads
    (4, 5121, 4, 128),   # ViT-L MAE decoder, 4 heads
    (4, 512, 16, 64)])   # ViT-L MAE encoder (511 + cls, no fold)
def test_packed_views_pass_as_they_are(b, n, h, d):
    """B2's q, k, v (column views of the fused buffer, tokens 1: with the
    cls row folded) and autograd's [:, 1:] dO need no copy."""
    cls = fa._cls_split(n)
    q, k, v, kc, vc = fa._split_qkv(_fused(b, n, h, d), cls)
    do = torch.zeros((b, n, h * d), dtype=torch.bfloat16)
    do = do[:, 1:] if cls else do
    for t in (q, k, v, do):
        assert fa._for_tma(t) is t
    assert q.stride(1) == 3 * h * d
    got = fa._packed_for_tma(q, k, v, kc, vc)
    assert all(a is b for a, b in zip(got, (q, k, v, kc, vc)))


@pytest.mark.parametrize("b,n,h,d", [
    (1, 4097, 16, 80),   # ViT-H/14 classifier (B4)
    (4, 512, 16, 80)])   # ViT-H/14 MAE encoder (B7)
def test_bh_views_pass_as_they_are(b, n, h, d):
    """B4's and B7's [B, H, N, D] views of the fused buffer (head stride
    D = 160 bytes, row stride 3*H*D) and autograd's transposed dO."""
    q, k, v = _bh_views(_fused(b, n, h, d), h)
    cls = fa._cls_split(n)
    kc = vc = None
    if cls:
        q, k, v, kc, vc = (q[:, :, 1:], k[:, :, 1:], v[:, :, 1:],
                           k[:, :, :1], v[:, :, :1])
    for t, tc in ((k, kc), (v, vc)):
        got = fa._kv_for_tma(t, tc)
        assert got[0] is t and got[1] is tc
    do = torch.zeros((b, n, h, d), dtype=torch.bfloat16).transpose(1, 2)
    do = do[:, :, 1:] if cls else do
    for t in (q, k, v, do):
        assert fa._for_tma(t) is t
        assert (t.stride(1) * 2) % 16 == 0 and (t.stride(2) * 2) % 16 == 0


def test_rect_shard_passes_as_it_is():
    """A 4-way shard of the decoder's 5,121 tokens padded to 5,124: 1,281
    query rows against 5,124 keys, contiguous [B, H, N, D]."""
    q = torch.zeros((4, 16, 1281, 32), dtype=torch.bfloat16)
    k = torch.zeros((4, 16, 5124, 32), dtype=torch.bfloat16)
    for t in (q, k, q[:, :, 1:]):
        assert fa._for_tma(t) is t


def _unaligned(what, h=2, d=80, n=130):
    """A [2, h, n, d] bf16 view that a tensor map cannot take."""
    if what == "base":
        x = torch.randn((2, n, 3 * h * d + 4)).to(torch.bfloat16)
        return x[..., 4:4 + h * d].view(2, n, h, d).transpose(1, 2)
    if what == "row stride":
        x = torch.randn((2, n, 3 * h * d + 1)).to(torch.bfloat16)
        return x[..., :h * d].view(2, n, h, d).transpose(1, 2)
    if what == "offset":
        x = torch.randn((2 * h * n * d + 2,)).to(torch.bfloat16)
        return x[2:].view(2, h, n, d)
    return torch.randn((2, h, d, n)).to(torch.bfloat16).transpose(2, 3)


@pytest.mark.parametrize("what", ["base", "row stride", "unit stride",
                                  "offset"])
def test_views_a_tensor_map_cannot_take_are_copied(what):
    """A column view 8 bytes off the 16-byte grid, a fused buffer whose row
    is not a multiple of 16 bytes, a view with a non-unit stride along D,
    and a contiguous view 2 elements (4 bytes) into its storage, which
    ``contiguous()`` would return as it is: each is copied to a contiguous
    tensor of the same values in aligned memory."""
    t = _unaligned(what)
    assert not fa._rows_aligned(t)
    assert t.is_contiguous() == (what == "offset")
    c = fa._for_tma(t)
    assert c is not t and c.is_contiguous() and fa._rows_aligned(c)
    assert torch.equal(c, t)


@pytest.mark.parametrize("what", ["base", "offset"])
def test_cls_rows_copy_with_their_keys(what):
    """k (or v) and its cls row: when either needs a copy, both come out of
    one copy of [cls; k], so they share the batch and head strides the
    kernels read the cls row with."""
    k = _unaligned(what)
    kc = torch.randn((2, 2, 1, 80)).to(torch.bfloat16)
    k2, kc2 = fa._kv_for_tma(k, kc)
    assert fa._rows_aligned(k2) and fa._rows_aligned(kc2)
    assert k2.stride()[:2] == kc2.stride()[:2]
    assert torch.equal(k2, k) and torch.equal(kc2, kc)


@pytest.mark.parametrize("cls", [False, True])
def test_packed_operands_copy_into_one_fused_buffer(cls):
    """B1's / B2's q, k, v (and kc, vc), separate tensors with unaligned or
    unequal strides, come out as the column views of one fused buffer of
    the same values: one row and one batch stride, as the kernels read."""
    b, m, h, d = 2, 130, 2, 64
    q = torch.randn((b, m, h * d + 4)).to(torch.bfloat16)[..., 4:]
    k, v = (torch.randn((b, m, h * d)).to(torch.bfloat16) for _ in range(2))
    kc, vc = ((torch.randn((b, 1, h * d)).to(torch.bfloat16)
               for _ in range(2)) if cls else (None, None))
    got = fa._packed_for_tma(q, k, v, kc, vc)
    for a, r in zip(got, (q, k, v, kc, vc)):
        assert (a is None) == (r is None)
        if r is not None:
            assert torch.equal(a, r) and fa._rows_aligned(a)
            assert a.stride() == got[0].stride()
    assert got[0].stride(1) == 3 * h * d


@pytest.mark.parametrize("b,h,nq,d,rows", [
    (4, 16, 5120, 32, 5120),    # ViT-L decoder h16, rows 1: of 5,121
    (4, 4, 5120, 128, 5120),    # ViT-L decoder h4
    (4, 16, 512, 64, 512),      # ViT-L encoder
    (1, 16, 4096, 80, 4096),    # ViT-H classifier (B4)
    (4, 16, 512, 80, 512),      # ViT-H encoder (B7)
    (4, 16, 1281, 32, 1408),    # a 4-way shard of the decoder
    (2, 2, 70, 80, 128), (1, 1, 129, 64, 256)])
def test_dq_accumulator_shape(b, h, nq, d, rows):
    """[B, H, nq rounded up to 128, D] fp32, zeroed: every query tile of
    the pass (64 or 128 rows) adds whole."""
    assert fa.DQ_ACC_ROWS == 128
    shape = (b, h, rows, d)
    assert fa.dq_accum_shape(b, h, nq, d, torch.bfloat16) == shape
    q = torch.zeros((1, 1, 1, d), dtype=torch.bfloat16)
    acc = fa._dq_accum(b, h, nq, d, q)
    assert acc.dtype == torch.float32 and tuple(acc.shape) == shape
    assert not acc.any()


@pytest.mark.parametrize("d,dtype", [(80, torch.float32), (256, torch.bfloat16),
                                     (32, torch.float32)])
def test_no_dq_accumulator_for_the_core_passes(d, dtype):
    """fp32 and head_dim 256 run the two CUDA-core passes, which sum dq
    within one block and take no accumulator."""
    assert fa.dq_accum_shape(2, 4, 300, d, dtype) is None
    assert fa._dq_accum(2, 4, 300, d, torch.zeros(1, dtype=dtype)) is None
