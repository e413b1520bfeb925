"""Fixed-shift flash attention on the packed-head layout.

Counterpart of ``octcubem_tpu/ops/flash_attention.py``'s packed path
(``flash_attention_packed_qkv`` / ``flash_attention_packed``).  Kernel B1
replaces the TPU kernel ``_fwd_kernel_packed``:

    s   = (q . k) * scale                       (fp32)
    p   = exp(min(s, NOMAX_CLAMP) - NOMAX_SHIFT)
    l   = sum p,   acc = sum p.astype(v.dtype) * v   (fp32)
    + one extra (cls) key/value folded in, when given
    o   = acc / l   (l <= 0 taken as 1),   lse = NOMAX_SHIFT + log l

Kernel B2 replaces ``_bwd_kernel_packed``, the backward of the same
function, given dO, lse and delta = rowsum(dO o) - g_lse per head:

    p   = exp(min(s, NOMAX_CLAMP) - lse)
    dv  = sum p.astype(dO.dtype) dO,   dp = dO . v
    ds  = (p (dp - delta), 0 where s > NOMAX_CLAMP).astype(q.dtype)
    dk  = sum ds q * scale,   dq = sum ds k * scale      (fp32)
    + the cls key/value's unrounded fp32 terms dkc, dvc and its share of dq

``fwd_packed`` and ``bwd_packed`` dispatch on the tensor's device: a CUDA
tensor launches the hand-written kernel (csrc/flash_fwd_packed.cu,
csrc/flash_bwd_packed.cu) or raises; a CPU tensor runs the plain
PyTorch version of the same function.  There is no fallback from the
card to the plain version.  The public functions are differentiable:
a ``torch.autograd.Function`` runs B1 forward, saving (o, lse), and B2
backward.

The JAX kernels pad the sequence to their tile and remove the known
e^-SHIFT mass of the zero pad keys (and of the zero "phantom" cls used
when n % 128 != 1); the CUDA kernels mask their ragged tiles instead, so
they need neither and compute the same function.
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


def _rows_aligned(t) -> bool:
    """Unit stride along the packed heads, a 16-byte aligned start, and
    row and batch strides in 16-byte multiples (the kernels' vector
    loads)."""
    es = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all((s * es) % 16 == 0 for s in t.stride()[:-1]))


def _check_rows(ts, what: str) -> None:
    if not all(_rows_aligned(t) for t in ts):
        raise ValueError(f"{what}: packed heads need unit stride and "
                         "16-byte aligned rows and strides")


def _check_kernel_inputs(q, k, v, kc, vc, num_heads: int) -> int:
    """The inputs B1 and B2 take -> head_dim; raises on anything else."""
    if q.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, not {q.device}")
    b, m, hd = q.shape
    d = _head_dim(hd, num_heads)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtype {q.dtype} not in (bfloat16, float32)")
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
    _check_rows((q, k, v, *cls), "q, k, v, kc, vc")
    return d


def fwd_packed_cuda(q, k, v, kc, vc, num_heads: int, scale: float):
    """B1 on the card.  q, k, v may be column views of one fused Wqkv
    buffer: they must share shape and strides, with unit stride along the
    packed heads.  kc / vc (the cls row of k / v) share k's batch
    stride."""
    b, m, hd = q.shape
    d = _check_kernel_inputs(q, k, v, kc, vc, num_heads)
    cls = kc is not None
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


def _delta(o, do, g_lse, num_heads: int):
    """delta = rowsum(dO o) - g_lse per head -> [B, H, m] fp32 (plain
    PyTorch outside the kernel, as in the JAX package)."""
    b, m, hd = o.shape
    d = hd // num_heads
    delta = torch.einsum("bnhd,bnhd->bhn", do.reshape(b, m, num_heads, d).float(),
                         o.reshape(b, m, num_heads, d).float())
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


def bwd_packed_plain(q, k, v, kc, vc, o, lse, do, g_lse, num_heads: int,
                     scale: float):
    """Plain PyTorch B2 (the JAX ``_bwd_packed_impl``).  q, k, v, o, do:
    [B, m, H*D]; kc, vc: [B, 1, H*D] or None; lse, g_lse: [B, H, m] fp32
    (g_lse may be None) -> (dq, dk, dv, dkc, dvc), dkc / dvc None without
    the cls fold."""
    b, m, hd = q.shape
    d = _head_dim(hd, num_heads)

    def heads(x):
        return x.reshape(b, x.shape[1], num_heads, d).float()

    qf, kf, vf, dof = heads(q), heads(k), heads(v), heads(do)
    delta = _delta(o, do, g_lse, num_heads)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    clamped = s > NOMAX_CLAMP
    p = torch.exp(torch.clamp(s, max=NOMAX_CLAMP) - lse[..., None])
    del s
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = torch.where(clamped, 0.0, p * (dp - delta[..., None]))
    del p, dp, clamped
    ds = ds.to(q.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dkc = dvc = None
    if kc is not None:
        kcf, vcf = heads(kc), heads(vc)                      # [B, 1, H, D]
        s_c = (qf * kcf).sum(-1) * scale                      # [B, m, H]
        p_c = torch.exp(torch.clamp(s_c, max=NOMAX_CLAMP)
                        - lse.transpose(1, 2))
        dp_c = (dof * vcf).sum(-1)
        ds_c = torch.where(s_c > NOMAX_CLAMP, 0.0,
                           p_c * (dp_c - delta.transpose(1, 2)))
        dvc = (p_c[..., None] * dof).sum(1, keepdim=True)
        dkc = (ds_c[..., None] * qf).sum(1, keepdim=True) * scale
        dq = dq + ds_c[..., None] * kcf * scale
        dkc = dkc.to(k.dtype).reshape(b, 1, hd)
        dvc = dvc.to(v.dtype).reshape(b, 1, hd)
    return (dq.to(q.dtype).reshape(b, m, hd), dk.to(k.dtype).reshape(b, m, hd),
            dv.to(v.dtype).reshape(b, m, hd), dkc, dvc)


def bwd_packed_cuda(q, k, v, kc, vc, o, lse, do, g_lse, num_heads: int,
                    scale: float, out=None):
    """B2 on the card.  Inputs as ``fwd_packed_cuda`` takes them, plus B1's
    o and lse and the incoming dO (any strides; copied only when its rows
    are not 16-byte aligned).  ``out``: (dq, dk, dv, dkc, dvc) to write
    into, e.g. column views of one dqkv buffer of the fused layout, with
    dq, dk, dv sharing shape and strides and dkc, dvc [B, 1, H*D] sharing
    a batch stride; allocated when None.  One kernel call (three
    launches: the dk/dv pass, the dq pass and the cls sums) counts
    once."""
    b, m, hd = q.shape
    d = _check_kernel_inputs(q, k, v, kc, vc, num_heads)
    cls = kc is not None
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("dO must match q's shape, dtype and device")
    if lse.shape != (b, num_heads, m) or lse.dtype != torch.float32:
        raise ValueError("lse must be [B, H, m] fp32")
    if not _rows_aligned(do):
        do = do.contiguous()
    lse = lse.contiguous()
    delta = _delta(o, do, g_lse, num_heads)
    if out is None:
        dq, dk, dv = (torch.empty((b, m, hd), dtype=q.dtype, device=q.device)
                      for _ in range(3))
        dkc, dvc = ((torch.empty((b, 1, hd), dtype=q.dtype, device=q.device)
                     for _ in range(2)) if cls else (None, None))
    else:
        dq, dk, dv, dkc, dvc = out
        for t in (dq, dk, dv):
            if (t.shape != q.shape or t.stride() != dq.stride()
                    or t.dtype != q.dtype or t.device != q.device):
                raise ValueError("dq, dk, dv must match q and share strides")
        if cls:
            for t in (dkc, dvc):
                if (t.shape != (b, 1, hd) or t.stride(0) != dkc.stride(0)
                        or t.dtype != q.dtype or t.device != q.device):
                    raise ValueError("dkc / dvc must be [B, 1, H*D] with one "
                                     "batch stride")
    _check_rows((dq, dk, dv) + ((dkc, dvc) if cls else ()), "dq, dk, dv")
    bf16 = int(q.dtype == torch.bfloat16)
    lib = _cuda.library("flash_bwd_packed")
    scratch = (torch.empty(lib.octcube_flash_bwd_packed_scratch(
        b, num_heads, m, d, bf16), dtype=torch.float32, device=q.device)
        if cls else None)
    with torch.cuda.device(q.device):
        err = lib.octcube_flash_bwd_packed(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kc.data_ptr() if cls else None, vc.data_ptr() if cls else None,
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dkc.data_ptr() if cls else None, dvc.data_ptr() if cls else None,
            scratch.data_ptr() if cls else None, b, num_heads, m, d,
            q.stride(1), q.stride(0), do.stride(1), do.stride(0),
            dq.stride(1), dq.stride(0), dkc.stride(0) if cls else 0,
            float(scale), bf16, torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(lib, err, "flash_bwd_packed")
    _cuda.launches["flash_bwd_packed"] += 1
    return dq, dk, dv, dkc, dvc


def bwd_packed(q, k, v, kc, vc, o, lse, do, g_lse, num_heads: int,
               scale: float, out=None):
    """B2 -> (dq, dk, dv, dkc, dvc): the kernel on a CUDA tensor, the plain
    version on a CPU tensor; ``out`` as in ``bwd_packed_cuda``."""
    if q.device.type == "cuda":
        return bwd_packed_cuda(q, k, v, kc, vc, o, lse, do, g_lse, num_heads,
                               scale, out)
    if q.device.type != "cpu":
        raise ValueError(f"no attention path for device {q.device}")
    grads = bwd_packed_plain(q, k, v, kc, vc, o, lse, do, g_lse, num_heads,
                             scale)
    if out is None:
        return grads
    for dst, src in zip(out, grads):
        if dst is not None:
            dst.copy_(src)
    return out


def _split_qkv(qkv, cls: bool):
    """The kernels' q, k, v, kc, vc as column views of the fused buffer:
    rows 1: with row 0 as the cls key/value, or all rows and no cls."""
    hd = qkv.shape[-1] // 3
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    if cls:
        return q[:, 1:], k[:, 1:], v[:, 1:], k[:, :1], v[:, :1]
    return q, k, v, None, None


class FlashPackedQKV(torch.autograd.Function):
    """B1 forward, B2 backward over the fused [B, N, 3*H*D] buffer (the
    JAX ``_flash_packed_fused``): ``apply(qkv, num_heads, scale, cls)`` ->
    (o, lse) of the kernel's rows, which are rows 1: with row 0 folded in
    as the cls key/value when ``cls``.  The backward writes dq, dk, dv,
    dkc and dvc straight into one dqkv buffer of qkv's layout (row 0's q
    columns are 0: the cls query row is differentiated apart)."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, scale: float, cls: bool):
        o, lse = fwd_packed(*_split_qkv(qkv, cls), num_heads, scale)
        ctx.save_for_backward(qkv, o, lse)
        ctx.num_heads, ctx.scale, ctx.cls = num_heads, scale, cls
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        qkv, o, lse = ctx.saved_tensors
        if g is None and g_lse is None:
            return None, None, None, None
        if g is None:
            g = torch.zeros_like(o)
        dqkv = torch.empty_like(qkv)
        if ctx.cls:
            dqkv[:, 0, :qkv.shape[-1] // 3].zero_()
        bwd_packed(*_split_qkv(qkv, ctx.cls), o, lse, g, g_lse, ctx.num_heads,
                   ctx.scale, out=_split_qkv(dqkv, ctx.cls))
        return dqkv, None, None, None


class FlashPacked(torch.autograd.Function):
    """B1 forward, B2 backward over separate q, k, v [B, m, H*D] and the
    optional cls row kc, vc (the JAX ``_flash_packed``):
    ``apply(q, k, v, kc, vc, num_heads, scale)`` -> (o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, kc, vc, num_heads: int, scale: float):
        o, lse = fwd_packed(q, k, v, kc, vc, num_heads, scale)
        ctx.save_for_backward(q, k, v, kc, vc, o, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, kc, vc, o, lse = ctx.saved_tensors
        if g is None and g_lse is None:
            return (None,) * 7
        if g is None:
            g = torch.zeros_like(o)
        grads = bwd_packed(q, k, v, kc, vc, o, lse, g, g_lse, ctx.num_heads,
                           ctx.scale)
        return (*grads, None, None)


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


def _cls_split(n: int) -> bool:
    """A cls-prefixed length (n % 128 == 1, n > 128) folds token 0 into
    the kernel as the extra key/value; any other n has no cls fold."""
    return n % 128 == 1 and n > 128


def flash_attention_packed(q, k, v, num_heads: int,
                           scale: float | None = None):
    """q, k, v: [B, N, H*D] -> [B, N, H*D].  Differentiable.

    A cls-prefixed sequence runs B1 on tokens 1: with token 0 folded in as
    the extra key/value, and its cls query row in plain PyTorch; any other
    n runs B1 over all tokens.  The backward is B2."""
    b, n, hd = q.shape
    d = _head_dim(hd, num_heads)
    scale = float(d ** -0.5 if scale is None else scale)
    if _cls_split(n):
        out_tok, _ = FlashPacked.apply(q[:, 1:], k[:, 1:], v[:, 1:], k[:, :1],
                                       v[:, :1], num_heads, scale)
        out_cls = _cls_query_row(q, k, v, num_heads, scale)
        return torch.cat([out_cls, out_tok], dim=1)
    out, _ = FlashPacked.apply(q, k, v, None, None, num_heads, scale)
    return out


def flash_attention_packed_qkv(qkv, num_heads: int,
                               scale: float | None = None):
    """qkv: [B, N, 3*H*D], the raw fused Wqkv projection -> [B, N, H*D].
    Differentiable.

    The kernels read q, k and v as column views of the fused buffer
    (q at column h*D, k at H*D + h*D, v at 2*H*D + h*D), so the slices
    never materialize, and B2 writes the gradient into one dqkv buffer."""
    b, n, hd3 = qkv.shape
    hd = hd3 // 3
    d = _head_dim(hd, num_heads)
    scale = float(d ** -0.5 if scale is None else scale)
    cls = _cls_split(n)
    out, _ = FlashPackedQKV.apply(qkv, num_heads, scale, cls)
    if not cls:
        return out
    out_cls = _cls_query_row(qkv[..., :hd], qkv[..., hd:2 * hd],
                             qkv[..., 2 * hd:], num_heads, scale)
    return torch.cat([out_cls, out], dim=1)
