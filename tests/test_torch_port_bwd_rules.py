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


@pytest.mark.parametrize("b,n,h,d", [
    (1, 4097, 16, 80),   # ViT-H/14 classifier (B4)
    (4, 512, 16, 80)])   # ViT-H/14 MAE encoder (B7)
def test_bh_views_pass_as_they_are(b, n, h, d):
    """B4's and B7's [B, H, N, D] views of the fused buffer (head stride
    D = 160 bytes, row stride 3*H*D) and autograd's transposed dO."""
    q, k, v = _bh_views(_fused(b, n, h, d), h)
    cls = fa._cls_split(n)
    if cls:
        q, k, v = q[:, :, 1:], k[:, :, 1:], v[:, :, 1:]
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


@pytest.mark.parametrize("what", ["base", "row stride", "unit stride"])
def test_views_a_tensor_map_cannot_take_are_copied(what):
    """A column view 8 bytes off the 16-byte grid, a fused buffer whose row
    is not a multiple of 16 bytes, and a view with a non-unit stride along
    D: each is copied to a contiguous tensor of the same values."""
    h, d = 2, 80
    if what == "base":
        x = torch.randn((2, 130, 3 * h * d + 4)).to(torch.bfloat16)
        t = x[..., 4:4 + h * d].view(2, 130, h, d).transpose(1, 2)
    elif what == "row stride":
        x = torch.randn((2, 130, 3 * h * d + 1)).to(torch.bfloat16)
        t = x[..., :h * d].view(2, 130, h, d).transpose(1, 2)
    else:
        t = torch.randn((2, h, d, 130)).to(torch.bfloat16).transpose(2, 3)
    assert not fa._rows_aligned(t)
    c = fa._for_tma(t)
    assert c is not t and c.is_contiguous() and fa._rows_aligned(c)
    assert torch.equal(c, t)


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
