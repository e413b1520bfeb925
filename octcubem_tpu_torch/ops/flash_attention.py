"""Fixed-shift flash attention on the packed-head layout (forward).

Counterpart of ``octcubem_tpu/ops/flash_attention.py``'s packed path
(``flash_attention_packed_qkv`` / ``flash_attention_packed``).  Its one
kernel, B1, replaces the TPU kernel ``_fwd_kernel_packed``:

    s   = (q . k) * scale                       (fp32)
    p   = exp(min(s, NOMAX_CLAMP) - NOMAX_SHIFT)
    l   = sum p,   acc = sum p.astype(v.dtype) * v   (fp32)
    + one extra (cls) key/value folded in, when given
    o   = acc / l   (l <= 0 taken as 1),   lse = NOMAX_SHIFT + log l

``fwd_packed`` dispatches on the tensor's device: a CUDA tensor launches
the hand-written kernel (csrc/flash_fwd_packed.cu) or raises; a CPU
tensor runs ``fwd_packed_plain``, the same function in plain PyTorch.
There is no fallback from the card to the plain version.

The JAX kernel pads the sequence to its tile and removes the known
e^-SHIFT mass of the zero pad keys (and of the zero "phantom" cls used
when n % 128 != 1); the CUDA kernel masks its ragged tiles instead, so
it needs neither and computes the same ``(o, lse)``.  Forward only: the
backward kernel (B2) comes with the training path.
"""

from __future__ import annotations

import torch

from . import _cuda

NOMAX_SHIFT = 16.0
NOMAX_CLAMP = 40.0
HEAD_DIMS = (32, 64, 128, 256)


def _head_dim(hd: int, num_heads: int) -> int:
    d = hd // num_heads
    if d * num_heads != hd or d not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}/{num_heads} not in {HEAD_DIMS}")
    return d


def fwd_packed_plain(q, k, v, kc, vc, num_heads: int, scale: float):
    """Plain PyTorch B1.  q, k, v: [B, m, H*D]; kc, vc: [B, 1, H*D] or
    None -> (o [B, m, H*D] in q's dtype, lse [B, H, m] fp32)."""
    b, m, hd = q.shape
    d = _head_dim(hd, num_heads)

    def heads(x):
        return x.reshape(b, x.shape[1], num_heads, d).float()

    qf = heads(q)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, heads(k)) * scale
    p = torch.exp(torch.clamp(s, max=NOMAX_CLAMP) - NOMAX_SHIFT)
    l = p.sum(-1)                                             # [B, H, m]
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), heads(v))
    if kc is not None:
        s_c = (qf * heads(kc)).sum(-1) * scale                # [B, m, H]
        p_c = torch.exp(torch.clamp(s_c, max=NOMAX_CLAMP) - NOMAX_SHIFT)
        l = l + p_c.transpose(1, 2)
        acc = acc + p_c[..., None] * heads(vc)
    l_safe = torch.where(l <= 0.0, torch.ones_like(l), l)
    o = acc / l_safe.transpose(1, 2)[..., None]
    return o.to(q.dtype).reshape(b, m, hd), NOMAX_SHIFT + torch.log(l_safe)


def fwd_packed_cuda(q, k, v, kc, vc, num_heads: int, scale: float):
    """B1 on the card.  q, k, v may be column views of one fused Wqkv
    buffer: they must share shape and strides, with unit stride along the
    packed heads.  kc / vc (the cls row of k / v) share k's batch
    stride."""
    if any(t is not None and t.requires_grad for t in (q, k, v, kc, vc)):
        raise NotImplementedError(
            "the CUDA attention path is forward-only: its backward kernel "
            "B2 (_bwd_kernel_packed) is not ported yet; run under "
            "torch.inference_mode()")
    if q.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, not {q.device}")
    b, m, hd = q.shape
    d = _head_dim(hd, num_heads)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtype {q.dtype} not in (bfloat16, float32)")
    es = q.element_size()
    cls = [t for t in (kc, vc) if t is not None]
    if len(cls) == 1:
        raise ValueError("kc and vc are given together or not at all")
    for t in (k, v, *cls):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k, v, kc, vc must share dtype and device")
    for t in (k, v):
        if t.shape != q.shape or t.stride() != q.stride():
            raise ValueError("q, k, v must share shape and strides")
    for t in cls:
        if t.shape != (b, 1, hd) or t.stride(0) != k.stride(0):
            raise ValueError("kc / vc must be [B, 1, H*D] rows of k's batch")
    for t in (q, k, v, *cls):
        if t.stride(-1) != 1 or t.data_ptr() % 16:
            raise ValueError("packed heads need unit stride and 16-byte "
                             "aligned rows")
    if (q.stride(1) * es) % 16 or (q.stride(0) * es) % 16:
        raise ValueError("row and batch strides must be 16-byte multiples")
    o = torch.empty((b, m, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, num_heads, m), dtype=torch.float32, device=q.device)
    lib = _cuda.library("flash_fwd_packed")
    with torch.cuda.device(q.device):
        err = lib.octcube_flash_fwd_packed(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kc.data_ptr() if cls else None, vc.data_ptr() if cls else None,
            o.data_ptr(), lse.data_ptr(), b, num_heads, m, d,
            q.stride(1), q.stride(0), o.stride(1), o.stride(0), float(scale),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(lib, err, "flash_fwd_packed")
    _cuda.launches["flash_fwd_packed"] += 1
    return o, lse


def fwd_packed(q, k, v, kc, vc, num_heads: int, scale: float):
    """B1 -> (o, lse): the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if q.device.type == "cuda":
        return fwd_packed_cuda(q, k, v, kc, vc, num_heads, scale)
    if q.device.type == "cpu":
        return fwd_packed_plain(q, k, v, kc, vc, num_heads, scale)
    raise ValueError(f"no attention path for device {q.device}")


def _cls_query_row(q, k, v, num_heads: int, scale: float):
    """The cls query's full softmax row, in the JAX package's order: fp32
    logits, softmax, probabilities cast to the input dtype, fp32 PV."""
    b, n, hd = k.shape
    d = hd // num_heads
    qc = q[:, :1].reshape(b, 1, num_heads, d).float()
    s_row = torch.einsum("bohd,bnhd->bhon", qc,
                         k.reshape(b, n, num_heads, d).float()) * scale
    p_row = torch.softmax(s_row, dim=-1)
    out = torch.einsum("bhon,bnhd->bohd", p_row.to(q.dtype).float(),
                       v.reshape(b, n, num_heads, d).float())
    return out.to(q.dtype).reshape(b, 1, hd)


def flash_attention_packed(q, k, v, num_heads: int,
                           scale: float | None = None):
    """q, k, v: [B, N, H*D] -> [B, N, H*D].  Forward.

    A cls-prefixed sequence (n % 128 == 1, n > 128) runs B1 on tokens 1:
    with token 0 folded in as the extra key/value, and its cls query row
    in plain PyTorch; any other n runs B1 over all tokens."""
    b, n, hd = q.shape
    d = _head_dim(hd, num_heads)
    if scale is None:
        scale = d ** -0.5
    if n % 128 == 1 and n > 128:
        out_tok, _ = fwd_packed(q[:, 1:], k[:, 1:], v[:, 1:], k[:, :1],
                                v[:, :1], num_heads, scale)
        out_cls = _cls_query_row(q, k, v, num_heads, scale)
        return torch.cat([out_cls, out_tok], dim=1)
    out, _ = fwd_packed(q, k, v, None, None, num_heads, scale)
    return out


def flash_attention_packed_qkv(qkv, num_heads: int,
                               scale: float | None = None):
    """qkv: [B, N, 3*H*D], the raw fused Wqkv projection -> [B, N, H*D].

    The kernel reads q, k and v as column views of the fused buffer
    (q at column h*D, k at H*D + h*D, v at 2*H*D + h*D), so the slices
    never materialize."""
    hd = qkv.shape[-1] // 3
    return flash_attention_packed(qkv[..., :hd], qkv[..., hd:2 * hd],
                                  qkv[..., 2 * hd:], num_heads, scale)
