"""Flash attention: the packed-head path and the ``[B, H, N, D]`` path,
with the fixed-shift softmax and the exact one.

Counterpart of ``octcubem_tpu/ops/flash_attention.py``.  Seven hand-written
CUDA kernels replace its TPU kernels; all but B6 compute one function,

    s   = (q . k) * scale                       (fp32)
    p   = exp(min(s, NOMAX_CLAMP) - NOMAX_SHIFT)
    l   = sum p,   acc = sum p.astype(v.dtype) * v   (fp32)
    + one extra (cls) key/value folded in, when given
    o   = acc / l   (l <= 0 taken as 1),   lse = NOMAX_SHIFT + log l

and its backward, given dO, lse and delta = rowsum(dO o) - g_lse per
head:

    p   = exp(min(s, NOMAX_CLAMP) - lse)
    dv  = sum p.astype(dO.dtype) dO,   dp = dO . v
    ds  = (p (dp - delta), 0 where s > NOMAX_CLAMP).astype(q.dtype)
    dk  = sum ds q * scale,   dq = sum ds k * scale      (fp32)
    + the cls key/value's unrounded fp32 terms dkc, dvc and its share of dq

- B1 ``_fwd_kernel_packed`` / B2 ``_bwd_kernel_packed``: the packed
  ``[B, N, H*D]`` layout (csrc/flash_fwd_packed.cu, flash_bwd_packed.cu),
  head_dim in ``HEAD_DIMS``;
- B3 ``_fwd_kernel_nomax_cls`` / B4 ``_fused_bwd_kernel_cls`` (with the cls
  fold) and B5 ``_fwd_kernel_nomax`` / B7 ``_fused_bwd_kernel`` (without;
  Nq != Nk with ``kv_valid`` too; B7 also the exact softmax's backward,
  ``no_max=False``): ``[B, H, N, D]`` views with any batch, head and row
  strides (csrc/flash_fwd_bh.cu, flash_bwd_bh.cu), head_dim in
  ``BH_HEAD_DIMS``;
- B6 ``_fwd_kernel``, the exact online softmax (``no_max=False``, no cls
  fold), on the same views and head dims: the running row max m over the
  keys, p = exp(s - m), l = sum p, acc = sum p.astype(v.dtype) * v, o =
  acc / l (l = 0 taken as 1), lse = m + log l; exact for any logits, where
  the fixed shift saturates above NOMAX_CLAMP.  Its backward is B7's
  ``no_max=False`` branch.

Each ``*_plain`` function is the plain PyTorch version of a kernel, any
head_dim.  The dispatchers (``fwd_packed``, ``bwd_packed``, ``fwd_bh``,
``bwd_bh``) go by the tensor's device: a CUDA tensor launches the kernel
or raises; a CPU tensor runs the plain version.  There is no fallback
from the card to the plain version.  The public functions are
differentiable through ``torch.autograd.Function``s that run a forward
kernel, save (o, lse), and run its backward kernel; lse is an output
whose cotangent folds into delta.  The backward takes delta precomputed
as well (the JAX ``_bwd_rect_prepare`` / ``_bwd_rect_core`` split), so
ring attention forms it once and not once per ring step.

B1 on the fused buffer is a ``torch.library`` custom op,
``octcubem_tpu_torch::flash_fwd_packed_qkv`` (``flash_fwd_packed_qkv_op``):
its CUDA implementation launches the kernel, its CPU one is the plain
version, and a fake gives the output shapes.  A forward that records no
gradient (serving) calls it, so ``torch.export`` keeps it in its graph
as one node per block (compat/aot.py): an exported program launches B1
on the card and runs the plain version on the CPU.  A forward under
autograd runs ``FlashPackedQKV``, which calls the kernels directly: the
op's dispatch adds host time to every call, and two of the host-bound
training steps read slower with it in every run of an A/B on the card
(PERF.md §6).

The JAX kernels pad the sequence to their tile and remove the known
e^-SHIFT mass of the zero pad keys (and of the zero "phantom" cls used
when n % 128 != 1, and of the zero tail keys past ``kv_valid``); the CUDA
kernels mask their ragged tiles and stop at ``kv_valid`` instead, so they
need no correction and compute the same function.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _cuda

NOMAX_SHIFT = 16.0
NOMAX_CLAMP = 40.0
HEAD_DIMS = (32, 64, 128, 256)          # B1, B2 on the card
BH_HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # B3-B7 on the card


def _split_heads(hd: int, num_heads: int) -> int:
    """head_dim of a packed width; raises unless the heads divide it."""
    d = hd // num_heads
    if d * num_heads != hd:
        raise ValueError(f"width {hd} is not {num_heads} whole heads")
    return d


def _bhnd(x, num_heads: int):
    """[B, m, H*D] -> the [B, H, m, D] view (no copy for unit-stride
    rows)."""
    b, m, hd = x.shape
    return x.reshape(b, m, num_heads, hd // num_heads).transpose(1, 2)


def _packed(x):
    """[B, H, m, D] -> [B, m, H*D] (no copy when heads lie inside rows)."""
    b, h, m, d = x.shape
    return x.transpose(1, 2).reshape(b, m, h * d)


# ------------------------------------------------------- the plain versions

def fwd_bh_plain(q, k, v, kc, vc, scale: float, kv_valid: int | None = None):
    """Plain PyTorch B3 (kc, vc given) and B5 (kc = vc = None; Nq != Nk
    and ``kv_valid`` for the rectangular form).  q: [B, H, Nq, D]; k, v:
    [B, H, Nk, D]; kc, vc: [B, H, 1, D] or None -> (o [B, H, Nq, D] in q's
    dtype, lse [B, H, Nq] fp32), over the first ``kv_valid`` keys (default
    all)."""
    if kv_valid is not None:
        k, v = k[:, :, :kv_valid], v[:, :, :kv_valid]
    qf = q.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, k.float()) * scale
    p = torch.exp(torch.clamp(s, max=NOMAX_CLAMP) - NOMAX_SHIFT)
    l = p.sum(-1)                                             # [B, H, Nq]
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    if kc is not None:
        s_c = (qf * kc.float()).sum(-1) * scale               # [B, H, Nq]
        p_c = torch.exp(torch.clamp(s_c, max=NOMAX_CLAMP) - NOMAX_SHIFT)
        l = l + p_c
        acc = acc + p_c[..., None] * vc.float()
    l_safe = torch.where(l <= 0.0, torch.ones_like(l), l)
    o = acc / l_safe[..., None]
    return o.to(q.dtype), NOMAX_SHIFT + torch.log(l_safe)


def fwd_bh_exact_plain(q, k, v, scale: float, kv_valid: int | None = None):
    """Plain PyTorch B6, the exact softmax over the full row.  q:
    [B, H, Nq, D]; k, v: [B, H, Nk, D] -> (o [B, H, Nq, D] in q's dtype,
    lse [B, H, Nq] fp32) over the first ``kv_valid`` keys (default all):
    s fp32, m = rowmax s, p = exp(s - m), l = sum p, o = (p.astype(v.dtype)
    v) / l with l = 0 taken as 1, lse = m + log l."""
    if kv_valid is not None:
        k, v = k[:, :, :kv_valid], v[:, :, :kv_valid]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    del s
    l = p.sum(-1)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(q.dtype), m + torch.log(l_safe)


def fwd_packed_plain(q, k, v, kc, vc, num_heads: int, scale: float):
    """Plain PyTorch B1.  q, k, v: [B, m, H*D]; kc, vc: [B, 1, H*D] or
    None -> (o [B, m, H*D] in q's dtype, lse [B, H, m] fp32).  B5's and
    B3's function on the packed layout."""
    _split_heads(q.shape[-1], num_heads)
    o, lse = fwd_bh_plain(*(None if t is None else _bhnd(t, num_heads)
                            for t in (q, k, v, kc, vc)), scale)
    return _packed(o), lse


def _delta_bh(o, do, g_lse):
    """delta = rowsum(dO o) - g_lse -> [B, H, m] fp32 (plain PyTorch
    outside the kernels, as in the JAX package)."""
    delta = torch.einsum("bhnd,bhnd->bhn", do.float(), o.float())
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


def _delta_cuda(lib, o, do, g_lse):
    """``_delta_bh`` on the card: the backward library's delta kernel (one
    read of o and dO, fp32 sums) for [B, H, n, D] views -> [B, H, n]
    fp32."""
    b, h, n, d = do.shape
    o = o.to(do.dtype)
    if o.stride(-1) != 1:
        o = o.contiguous()
    delta = torch.empty((b, h, n), dtype=torch.float32, device=do.device)
    g = None if g_lse is None else g_lse.float().contiguous()
    with torch.cuda.device(do.device):
        err = lib.octcube_flash_bwd_delta(
            o.data_ptr(), do.data_ptr(), _ptr(g), delta.data_ptr(), b, h, n, d,
            _strides(o, do), int(do.dtype == torch.bfloat16),
            torch.cuda.current_stream(do.device).cuda_stream)
    _cuda.check(lib, err, "flash_bwd delta")
    return delta


def bwd_bh_plain(q, k, v, kc, vc, o, lse, do, g_lse, scale: float,
                 no_max: bool = True, kv_valid: int | None = None,
                 delta=None):
    """Plain PyTorch B4 (kc, vc given) and B7 (kc = vc = None; Nq != Nk
    and ``kv_valid`` for the rectangular form; ``no_max=False`` for the
    exact softmax's backward: no clamp in p, ds unmasked).  q, o, do:
    [B, H, Nq, D]; k, v: [B, H, Nk, D]; kc, vc: [B, H, 1, D] or None; lse,
    g_lse: [B, H, Nq] fp32 (g_lse may be None) -> (dq, dk, dv, dkc, dvc),
    dkc / dvc None without the cls fold; key rows at or past ``kv_valid``
    get dk = dv = 0.  ``delta``: rowsum(dO o) - g_lse [B, H, Nq] fp32,
    computed here from o, dO and g_lse when None (then o and g_lse are not
    read)."""
    nk = k.shape[2]
    if kv_valid is not None:
        k, v = k[:, :, :kv_valid], v[:, :, :kv_valid]
    clamp = NOMAX_CLAMP if no_max else math.inf
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    if delta is None:
        delta = _delta_bh(o, do, g_lse)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    clamped = s > clamp
    p = torch.exp(torch.clamp(s, max=clamp) - lse[..., None])
    del s
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = torch.where(clamped, 0.0, p * (dp - delta[..., None]))
    del p, dp, clamped
    ds = ds.to(q.dtype).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dkc = dvc = None
    if kc is not None:
        kcf, vcf = kc.float(), vc.float()                     # [B, H, 1, D]
        s_c = (qf * kcf).sum(-1) * scale                      # [B, H, Nq]
        p_c = torch.exp(torch.clamp(s_c, max=clamp) - lse)
        dp_c = (dof * vcf).sum(-1)
        ds_c = torch.where(s_c > clamp, 0.0, p_c * (dp_c - delta))
        dvc = (p_c[..., None] * dof).sum(2, keepdim=True).to(vc.dtype)
        dkc = ((ds_c[..., None] * qf).sum(2, keepdim=True) * scale).to(kc.dtype)
        dq = dq + ds_c[..., None] * kcf * scale
    if dk.shape[2] < nk:  # the tail past kv_valid
        pad = (0, 0, 0, nk - dk.shape[2])
        dk, dv = (torch.nn.functional.pad(t, pad) for t in (dk, dv))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dkc, dvc


def bwd_packed_plain(q, k, v, kc, vc, o, lse, do, g_lse, num_heads: int,
                     scale: float):
    """Plain PyTorch B2 (the JAX ``_bwd_packed_impl``).  q, k, v, o, do:
    [B, m, H*D]; kc, vc: [B, 1, H*D] or None; lse, g_lse: [B, H, m] fp32
    (g_lse may be None) -> (dq, dk, dv, dkc, dvc), dkc / dvc None without
    the cls fold.  B4's and B7's function on the packed layout."""
    _split_heads(q.shape[-1], num_heads)
    grads = bwd_bh_plain(*(None if t is None else _bhnd(t, num_heads)
                           for t in (q, k, v, kc, vc, o)), lse,
                         _bhnd(do, num_heads), g_lse, scale)
    return tuple(None if g is None else _packed(g) for g in grads)


# ------------------------------------------------------- the kernels' inputs

def _kernel_head_dim(d: int, dims: tuple[int, ...], what: str) -> None:
    if d not in dims:
        raise ValueError(f"{what} on the card takes head_dim in {dims}, "
                         f"not {d}")


def _rows_aligned(t) -> bool:
    """Unit stride along D, a 16-byte aligned start, and every other
    stride a 16-byte multiple (the kernels' vector loads)."""
    es = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all((s * es) % 16 == 0 for s in t.stride()[:-1]))


def _for_tma(t):
    """``t`` itself when a TMA tensor map can describe it with its own
    strides (``_rows_aligned``: cuTensorMapEncodeTiled takes a 16-byte
    aligned base and strides that are multiples of 16 bytes), else a
    contiguous copy in fresh (aligned) memory: ``contiguous()`` would hand
    back a contiguous view whose base is off the grid as it is.  The bf16
    kernels load q, k, v and dO through such maps; the fused buffer's
    column views and autograd's dO pass as they are."""
    if _rows_aligned(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _kv_for_tma(t, tc):
    """k (or v) [..., rows, D] and its cls row ``tc`` [..., 1, D] (or None)
    for the kernels, which read the cls row with t's batch and head
    strides: both as they are when aligned and so strided, else one copy
    of [tc; t] along the rows, split again."""
    if tc is None:
        return _for_tma(t), None
    if (tc.dtype != t.dtype or tc.shape != t.shape[:-2] + (1, t.shape[-1])
            or (_rows_aligned(t) and _rows_aligned(tc)
                and tc.stride()[:-2] == t.stride()[:-2])):
        return t, tc  # the wrapper's checks raise on what does not fit
    both = torch.cat([tc, t], dim=-2)
    return both[..., 1:, :], both[..., :1, :]


def _packed_for_tma(q, k, v, kc, vc):
    """B1's and B2's q, k, v, kc, vc ([B, m, H*D], the cls rows
    [B, 1, H*D] or None), which the kernels read with one row and batch
    stride: as they are when a tensor map takes each and they share those
    strides, else copied into one fused [B, (1 +) m, 3*H*D] buffer laid
    out as the model's and split again."""
    cls = kc is not None
    ts = (q, k, v, kc, vc) if cls else (q, k, v)
    if (cls != (vc is not None) or not q.shape == k.shape == v.shape
            or any(t.dtype != q.dtype for t in ts)
            or (all(_rows_aligned(t) for t in ts)
                and q.stride() == k.stride() == v.stride()
                and all(t.stride(0) == k.stride(0) for t in ts))):
        return q, k, v, kc, vc
    b, m, hd = q.shape
    buf = q.new_zeros((b, m + cls, 3 * hd))
    for i, (t, tc) in enumerate(((q, None), (k, kc), (v, vc))):
        cols = slice(i * hd, (i + 1) * hd)
        buf[:, cls:, cols] = t
        if cls and tc is not None:
            buf[:, :1, cols] = tc  # q's cls row stays 0, unread
    return _split_qkv(buf, cls)


# the bf16 backward's fp32 dq accumulator pads the query rows to whole
# tiles of its pass (csrc/flash_bwd.cuh, kAccRows)
DQ_ACC_ROWS = 128


def dq_accum_shape(b: int, h: int, nq: int, d: int, dtype):
    """The fp32 dq accumulator the bf16 one-pass backward (head_dim <= 128)
    adds every key tile's share into: [B, H, nq rounded up to DQ_ACC_ROWS,
    D], zeroed by the wrapper.  None where the CUDA-core passes run (fp32,
    head_dim 256), which need none."""
    if dtype != torch.bfloat16 or d > 128:
        return None
    return (b, h, -(-nq // DQ_ACC_ROWS) * DQ_ACC_ROWS, d)


def _dq_accum(b: int, h: int, nq: int, d: int, q):
    shape = dq_accum_shape(b, h, nq, d, q.dtype)
    return (None if shape is None else
            torch.zeros(shape, dtype=torch.float32, device=q.device))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_rows(ts, what: str) -> None:
    if not all(_rows_aligned(t) for t in ts):
        raise ValueError(f"{what}: rows need unit stride along D and "
                         "16-byte aligned starts and strides")


def _check_types(q, ts) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, not {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtype {q.dtype} not in (bfloat16, float32)")
    for t in ts:
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k, v, kc, vc must share dtype and device")


def _check_kernel_inputs(q, k, v, kc, vc, num_heads: int) -> int:
    """The inputs B1 and B2 take -> head_dim; raises on anything else."""
    b, m, hd = q.shape
    d = _split_heads(hd, num_heads)
    _kernel_head_dim(d, HEAD_DIMS, "B1 / B2")
    cls = [t for t in (kc, vc) if t is not None]
    if len(cls) == 1:
        raise ValueError("kc and vc are given together or not at all")
    _check_types(q, (k, v, *cls))
    for t in (k, v):
        if t.shape != q.shape or t.stride() != q.stride():
            raise ValueError("q, k, v must share shape and strides")
    for t in cls:
        if t.shape != (b, 1, hd) or t.stride(0) != k.stride(0):
            raise ValueError("kc / vc must be [B, 1, H*D] rows of k's batch")
    _check_rows((q, k, v, *cls), "q, k, v, kc, vc")
    return d


# ------------------------------------------------------ packed: B1 and B2

def fwd_packed_cuda(q, k, v, kc, vc, num_heads: int, scale: float):
    """B1 on the card.  q, k, v may be column views of one fused Wqkv
    buffer: they must share shape and strides, with unit stride along the
    packed heads.  kc / vc (the cls row of k / v) share k's batch
    stride."""
    b, m, hd = q.shape
    q, k, v, kc, vc = _packed_for_tma(q, k, v, kc, vc)
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


def bwd_packed_cuda(q, k, v, kc, vc, o, lse, do, g_lse, num_heads: int,
                    scale: float, out=None):
    """B2 on the card.  Inputs as ``fwd_packed_cuda`` takes them, plus B1's
    o and lse and the incoming dO (any strides; copied only when its rows
    are not 16-byte aligned).  ``out``: (dq, dk, dv, dkc, dvc) to write
    into, e.g. column views of one dqkv buffer of the fused layout, with
    dq, dk, dv sharing shape and strides and dkc, dvc [B, 1, H*D] sharing
    a batch stride; allocated when None.  One kernel call counts once
    (``bwd_bh_cuda`` says what it launches)."""
    b, m, hd = q.shape
    q, k, v, kc, vc = _packed_for_tma(q, k, v, kc, vc)
    d = _check_kernel_inputs(q, k, v, kc, vc, num_heads)
    cls = kc is not None
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("dO must match q's shape, dtype and device")
    if lse.shape != (b, num_heads, m) or lse.dtype != torch.float32:
        raise ValueError("lse must be [B, H, m] fp32")
    do = _for_tma(do)
    lse = lse.contiguous()
    lib = _cuda.library("flash_bwd_packed")
    delta = _delta_cuda(lib, _bhnd(o, num_heads), _bhnd(do, num_heads), g_lse)
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
    scratch = (torch.empty(lib.octcube_flash_bwd_packed_scratch(
        b, num_heads, m, d, bf16), dtype=torch.float32, device=q.device)
        if cls else None)
    acc = _dq_accum(b, num_heads, m, d, q)
    with torch.cuda.device(q.device):
        err = lib.octcube_flash_bwd_packed(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kc), _ptr(vc),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(dkc), _ptr(dvc),
            _ptr(scratch), _ptr(acc), b, num_heads, m, d,
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


# ------------------------------------------ [B, H, N, D]: B3-B7

def _check_bh_inputs(q, k, v, kc, vc) -> int:
    """The inputs B3-B7 take -> head_dim; raises on anything
    else.  Every operand has its own strides; kc / vc share k's / v's
    batch and head strides."""
    b, h, nq, d = q.shape
    _kernel_head_dim(d, BH_HEAD_DIMS, "B3-B7")
    cls = [t for t in (kc, vc) if t is not None]
    if len(cls) == 1:
        raise ValueError("kc and vc are given together or not at all")
    _check_types(q, (k, v, *cls))
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError("k, v must be [B, H, Nk, D] of q's B, H and D")
    for t, kv in zip(cls, (k, v)):
        if t.shape != (b, h, 1, d) or t.stride()[:2] != kv.stride()[:2]:
            raise ValueError("kc / vc must be [B, H, 1, D] rows of k / v")
    _check_rows((q, k, v, *cls), "q, k, v, kc, vc")
    return d


def _empty_like_rows(t, dtype=None):
    """An empty [B, H, rows, D] tensor laid out as ``t`` is: heads inside
    rows ([B, rows, H, D] memory, so that the packed view of it is free)
    when t's head stride is below its row stride, else contiguous."""
    b, h, n, d = t.shape
    dtype = dtype or t.dtype
    if t.stride(1) < t.stride(2):
        return torch.empty((b, n, h, d), dtype=dtype,
                           device=t.device).transpose(1, 2)
    return torch.empty((b, h, n, d), dtype=dtype, device=t.device)


def _strides(*ts):
    """The kernels' stride array: (batch, head, row) of each tensor, each
    below 2^31 (the kernels keep 32-bit strides)."""
    vals = [s for t in ts for s in t.stride()[:3]]
    if max(vals) >= 2 ** 31:
        raise ValueError("a stride of 2^31 elements or more")
    return (ctypes.c_longlong * len(vals))(*vals)


def _kv_valid(kv_valid, nk: int) -> int:
    kv = nk if kv_valid is None else int(kv_valid)
    if not 1 <= kv <= nk:
        raise ValueError(f"kv_valid {kv_valid} not in [1, {nk}]")
    return kv


def fwd_bh_cuda(q, k, v, kc, vc, scale: float, kv_valid: int | None = None,
                no_max: bool = True):
    """B3 (kc, vc given), B5, or with ``no_max=False`` B6 (no cls fold) on
    the card.  q [B, H, Nq, D], k, v [B, H, Nk, D], kc, vc [B, H, 1, D],
    each with any batch, head and row strides and unit stride along D (e.g.
    the [B, H, N, D] views of a fused Wqkv buffer).  o comes out laid out
    as q is (``_empty_like_rows``)."""
    b, h, nq, d = q.shape
    q = _for_tma(q)
    (k, kc), (v, vc) = _kv_for_tma(k, kc), _kv_for_tma(v, vc)
    d = _check_bh_inputs(q, k, v, kc, vc)
    kv = _kv_valid(kv_valid, k.shape[2])
    cls = kc is not None
    if cls and not no_max:
        raise ValueError("the cls fold is a fixed-shift (no_max) path")
    o = _empty_like_rows(q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    lib = _cuda.library("flash_fwd_bh")
    with torch.cuda.device(q.device):
        err = lib.octcube_flash_fwd_bh(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kc.data_ptr() if cls else None, vc.data_ptr() if cls else None,
            o.data_ptr(), lse.data_ptr(), b, h, nq, kv, d,
            _strides(q, k, v, o), float(scale),
            int(q.dtype == torch.bfloat16), int(not no_max),
            torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(lib, err, "flash_fwd_bh")
    counter = ("flash_fwd_bh_cls" if cls else
               "flash_fwd_bh" if no_max else "flash_fwd_bh_exact")
    _cuda.launches[counter] += 1
    return o, lse


def fwd_bh(q, k, v, kc, vc, scale: float, kv_valid: int | None = None,
           no_max: bool = True):
    """B3 / B5, or B6 with ``no_max=False`` -> (o, lse): the kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cuda":
        return fwd_bh_cuda(q, k, v, kc, vc, scale, kv_valid, no_max)
    if q.device.type != "cpu":
        raise ValueError(f"no attention path for device {q.device}")
    if no_max:
        return fwd_bh_plain(q, k, v, kc, vc, scale, kv_valid)
    if kc is not None:
        raise ValueError("the cls fold is a fixed-shift (no_max) path")
    return fwd_bh_exact_plain(q, k, v, scale, kv_valid)


def bwd_bh_cuda(q, k, v, kc, vc, o, lse, do, g_lse, scale: float,
                no_max: bool = True, kv_valid: int | None = None,
                delta=None):
    """B4 (kc, vc given) or B7 on the card.  Inputs as ``fwd_bh_cuda``
    takes them, plus the forward's o and lse and the incoming dO (any
    strides; copied only when its rows are not 16-byte aligned) -> (dq,
    dk, dv, dkc, dvc), dq, dk, dv laid out as q, k, v are, dkc / dvc
    [B, H, 1, D].  ``delta`` as ``bwd_bh_plain`` takes it.  q, k, v and
    dO that a TMA tensor map cannot describe are copied (``_for_tma``).
    One kernel call counts once: in bf16 at head_dim <= 128, one pass over
    the key tiles (dk, dv, and each tile's share of dq added into a zeroed
    fp32 accumulator, ``dq_accum_shape``), the dq epilogue and, with the
    cls fold, the cls sums; dq is then not bit-identical from run to run
    (the fp32 adds arrive in varying order), dk, dv, dkc and dvc are.
    fp32 and head_dim 256 run two CUDA-core passes and the cls sums."""
    b, h, nq, d = q.shape
    q = _for_tma(q)
    (k, kc), (v, vc) = _kv_for_tma(k, kc), _kv_for_tma(v, vc)
    d = _check_bh_inputs(q, k, v, kc, vc)
    nk = k.shape[2]
    kv = _kv_valid(kv_valid, nk)
    cls = kc is not None
    if cls and not no_max:
        raise ValueError("the cls fold is a fixed-shift (no_max) path")
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("dO must match q's shape, dtype and device")
    if lse.shape != (b, h, nq) or lse.dtype != torch.float32:
        raise ValueError("lse must be [B, H, Nq] fp32")
    do = _for_tma(do)
    lse = lse.contiguous()
    lib = _cuda.library("flash_bwd_bh")
    if delta is None:
        delta = _delta_cuda(lib, o, do, g_lse)
    elif delta.shape != (b, h, nq) or delta.dtype != torch.float32:
        raise ValueError("delta must be [B, H, Nq] fp32")
    delta = delta.contiguous()
    dq, dk, dv = (_empty_like_rows(t) for t in (q, k, v))
    dkc, dvc = ((torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
                 for _ in range(2)) if cls else (None, None))
    bf16 = int(q.dtype == torch.bfloat16)
    scratch = (torch.empty(lib.octcube_flash_bwd_bh_scratch(b, h, nq, d, bf16),
                           dtype=torch.float32, device=q.device)
               if cls else None)
    acc = _dq_accum(b, h, nq, d, q)
    # dkc / dvc share one layout; without the cls fold q's stands in, unread
    strides = _strides(q, k, v, do, dq, dk, dv, dkc if cls else q)
    with torch.cuda.device(q.device):
        err = lib.octcube_flash_bwd_bh(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kc), _ptr(vc),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(dkc), _ptr(dvc),
            _ptr(scratch), _ptr(acc), b, h, nq, nk, kv, d, strides,
            float(scale), int(no_max), bf16,
            torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(lib, err, "flash_bwd_bh")
    _cuda.launches["flash_bwd_bh_cls" if cls else "flash_bwd_bh"] += 1
    return dq, dk, dv, dkc, dvc


def bwd_bh(q, k, v, kc, vc, o, lse, do, g_lse, scale: float,
           no_max: bool = True, kv_valid: int | None = None, delta=None):
    """B4 / B7 -> (dq, dk, dv, dkc, dvc): the kernel on a CUDA tensor, the
    plain version on a CPU tensor; ``delta`` as ``bwd_bh_plain`` takes
    it."""
    if q.device.type == "cuda":
        return bwd_bh_cuda(q, k, v, kc, vc, o, lse, do, g_lse, scale, no_max,
                           kv_valid, delta)
    if q.device.type == "cpu":
        return bwd_bh_plain(q, k, v, kc, vc, o, lse, do, g_lse, scale, no_max,
                            kv_valid, delta)
    raise ValueError(f"no attention path for device {q.device}")


# ---------------------------------------------------- autograd Functions

def _zero_grad_if_none(g, o):
    return torch.zeros_like(o) if g is None else g


class FlashBHRect(torch.autograd.Function):
    """B5 forward (B6 with ``no_max=False``), B7 backward (the JAX
    ``_flash_bh_rect``): ``apply(q, k, v, scale, kv_valid, no_max=True)``
    with q [B, H, Nq, D] and k, v [B, H, Nk, D] -> (o, lse) over the first
    ``kv_valid`` keys (None: all); dk and dv are 0 in the rows at or past
    it."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, kv_valid, no_max: bool = True):
        o, lse = fwd_bh(q, k, v, None, None, scale, kv_valid, no_max)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.kv_valid, ctx.no_max = scale, kv_valid, no_max
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if g is None and g_lse is None:
            return (None,) * 6
        dq, dk, dv, _, _ = bwd_bh(q, k, v, None, None, o, lse,
                                  _zero_grad_if_none(g, o), g_lse, ctx.scale,
                                  ctx.no_max, ctx.kv_valid)
        return dq, dk, dv, None, None, None


class FlashBH(FlashBHRect):
    """B5 forward (B6 with ``no_max=False``), B7 backward over
    [B, H, N, D] (the JAX ``_flash_bh``): ``apply(q, k, v, scale,
    no_max=True)`` -> (o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, no_max: bool = True):
        return FlashBHRect.forward(ctx, q, k, v, scale, None, no_max)

    @staticmethod
    def backward(ctx, g, g_lse):
        return FlashBHRect.backward(ctx, g, g_lse)[:5]


class FlashBHCls(torch.autograd.Function):
    """B3 forward, B4 backward (the JAX ``_flash_bh_cls``):
    ``apply(q, k, v, kc, vc, scale)`` with q, k, v [B, H, m, D] and the
    cls key/value kc, vc [B, H, 1, D] -> (o, lse); the backward gives dq,
    dk, dv, dkc and dvc."""

    @staticmethod
    def forward(ctx, q, k, v, kc, vc, scale: float):
        o, lse = fwd_bh(q, k, v, kc, vc, scale)
        ctx.save_for_backward(q, k, v, kc, vc, o, lse)
        ctx.scale = scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, kc, vc, o, lse = ctx.saved_tensors
        if g is None and g_lse is None:
            return (None,) * 6
        grads = bwd_bh(q, k, v, kc, vc, o, lse, _zero_grad_if_none(g, o),
                       g_lse, ctx.scale)
        return (*grads, None)


def _split_qkv(qkv, cls: bool):
    """The kernels' q, k, v, kc, vc as column views of the fused buffer:
    rows 1: with row 0 as the cls key/value, or all rows and no cls."""
    hd = qkv.shape[-1] // 3
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    if cls:
        return q[:, 1:], k[:, 1:], v[:, 1:], k[:, :1], v[:, :1]
    return q, k, v, None, None


@torch.library.custom_op("octcubem_tpu_torch::flash_fwd_packed_qkv",
                         mutates_args=(), device_types="cpu")
def flash_fwd_packed_qkv_op(qkv: torch.Tensor, num_heads: int, scale: float,
                            cls: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """B1 over the fused [B, N, 3*H*D] buffer -> (o [B, m, H*D], lse
    [B, H, m] fp32), m = N - cls, on the fused buffer's column views
    (``_split_qkv``).  This is the CPU implementation, the plain
    version."""
    return fwd_packed_plain(*_split_qkv(qkv, cls), num_heads, scale)


@flash_fwd_packed_qkv_op.register_kernel("cuda")
def _flash_fwd_packed_qkv_cuda(qkv, num_heads, scale, cls):
    return fwd_packed_cuda(*_split_qkv(qkv, cls), num_heads, scale)


@flash_fwd_packed_qkv_op.register_fake
def _flash_fwd_packed_qkv_fake(qkv, num_heads, scale, cls):
    b, n, hd3 = qkv.shape
    m = n - int(cls)
    return (qkv.new_empty((b, m, hd3 // 3)),
            qkv.new_empty((b, num_heads, m), dtype=torch.float32))


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
        dqkv = torch.empty_like(qkv)
        if ctx.cls:
            dqkv[:, 0, :qkv.shape[-1] // 3].zero_()
        bwd_packed(*_split_qkv(qkv, ctx.cls), o, lse, _zero_grad_if_none(g, o),
                   g_lse, ctx.num_heads, ctx.scale,
                   out=_split_qkv(dqkv, ctx.cls))
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
        grads = bwd_packed(q, k, v, kc, vc, o, lse, _zero_grad_if_none(g, o),
                           g_lse, ctx.num_heads, ctx.scale)
        return (*grads, None, None)


# ------------------------------------------------------------- public ops

def _cls_query_row(q, k, v, scale: float):
    """The cls query's full softmax row on [B, H, N, D], in the JAX
    package's order: fp32 logits, softmax, probabilities cast to the input
    dtype, fp32 PV -> [B, H, 1, D]."""
    s_row = torch.einsum("bhod,bhnd->bhon", q[:, :, :1].float(),
                         k.float()) * scale
    p_row = torch.softmax(s_row, dim=-1)
    out = torch.einsum("bhon,bhnd->bhod", p_row.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def _cls_split(n: int) -> bool:
    """A cls-prefixed length (n % 128 == 1, n > 128) folds token 0 into
    the kernel as the extra key/value; any other n has no cls fold."""
    return n % 128 == 1 and n > 128


def _split_cls_attention(q, k, v, scale: float):
    """Attention for a cls-prefixed [B, H, N, D] sequence: B3 / B4 on
    tokens 1: with token 0 folded in as the extra key/value, and the cls
    query's row in plain PyTorch (the JAX ``_split_cls_attention``)."""
    out_tok, _ = FlashBHCls.apply(q[:, :, 1:], k[:, :, 1:], v[:, :, 1:],
                                  k[:, :, :1], v[:, :, :1], scale)
    return torch.cat([_cls_query_row(q, k, v, scale), out_tok], dim=2)


def flash_attention(q, k, v, scale: float | None = None, no_max: bool = True):
    """q, k, v: [B, H, N, D] -> [B, H, N, D].  Differentiable.

    ``no_max=True``, the fixed-shift softmax: a cls-prefixed sequence
    (n % 128 == 1, n > 128) runs B3 / B4 on tokens 1:
    (``_split_cls_attention``); any other n runs B5 / B7.
    ``no_max=False``, the exact online softmax: B6 / B7 over all n tokens,
    with no cls split (as the JAX package).  Any batch, head and row
    strides with unit stride along D reach the kernels as they are.  The
    TPU tiling knobs ``block_q`` / ``block_k`` are not carried over."""
    d, n = q.shape[-1], q.shape[2]
    scale = float(d ** -0.5 if scale is None else scale)
    if no_max and _cls_split(n):
        return _split_cls_attention(q, k, v, scale)
    out, _ = FlashBH.apply(q, k, v, scale, bool(no_max))
    return out


def flash_attention_rect(q, k, v, scale: float | None = None,
                         no_max: bool = True, kv_valid: int | None = None):
    """Cross-attention-shaped flash: q [B, H, Nq, D] against k, v
    [B, H, Nk, D], Nq != Nk allowed.  Differentiable; B5 / B7, or B6 / B7
    with ``no_max=False``.

    Only the first ``kv_valid`` keys (default all) are attended: the
    kernels mask the keys at or past it (B6 with -inf, as the JAX
    ``_fwd_kernel`` does with NEG_INF), so the tail rows of k and v may
    hold anything.  The JAX fixed-shift kernel instead needs them zero
    (its caller zeroes them and their gradient); its backward leaves
    values there, the kernels here write zeros, so the two agree through
    that zeroing."""
    d = q.shape[-1]
    scale = float(d ** -0.5 if scale is None else scale)
    kv = _kv_valid(kv_valid, k.shape[2])
    out, _ = FlashBHRect.apply(q, k, v, scale, kv, bool(no_max))
    return out


def flash_attention_packed(q, k, v, num_heads: int,
                           scale: float | None = None, no_max: bool = True):
    """q, k, v: [B, N, H*D] -> [B, N, H*D].  Differentiable.

    A head_dim that B1 / B2 serve (``HEAD_DIMS``) runs them: a cls-prefixed
    sequence runs B1 on tokens 1: with token 0 folded in as the extra
    key/value, and its cls query row in plain PyTorch; any other n runs
    B1 over all tokens; the backward is B2.  Any other head_dim (80 for
    the ViT-H/14 family at 16 heads, 16 for the HIPT ViT-4K at 12) goes
    to ``flash_attention`` on the [B, H, N, D] views, as the JAX package
    falls back for shapes its packed kernels do not serve, and so does ``no_max=False`` (the exact
    softmax, B6 / B7), as in the JAX package.  The JAX rule there is the
    TPU's lane grouping (G = 128 / d heads per kernel instance); B1
    indexes heads by stride, so only the head_dim decides here."""
    b, n, hd = q.shape
    d = _split_heads(hd, num_heads)
    scale = float(d ** -0.5 if scale is None else scale)
    if not no_max or d not in HEAD_DIMS:
        return _packed(flash_attention(_bhnd(q, num_heads), _bhnd(k, num_heads),
                                       _bhnd(v, num_heads), scale=scale,
                                       no_max=no_max))
    if _cls_split(n):
        out_tok, _ = FlashPacked.apply(q[:, 1:], k[:, 1:], v[:, 1:], k[:, :1],
                                       v[:, :1], num_heads, scale)
        out_cls = _cls_query_row(_bhnd(q[:, :1], num_heads),
                                 _bhnd(k, num_heads), _bhnd(v, num_heads),
                                 scale)
        return torch.cat([_packed(out_cls), out_tok], dim=1)
    out, _ = FlashPacked.apply(q, k, v, None, None, num_heads, scale)
    return out


def flash_attention_packed_qkv(qkv, num_heads: int,
                               scale: float | None = None,
                               no_max: bool = True):
    """qkv: [B, N, 3*H*D], the raw fused Wqkv projection -> [B, N, H*D].
    Differentiable.

    The kernels read q, k and v as column views of the fused buffer
    (q at column h*D, k at H*D + h*D, v at 2*H*D + h*D), so the slices
    never materialize, and B2 writes the gradient into one dqkv buffer.
    A head_dim outside ``HEAD_DIMS``, or ``no_max=False``, goes to
    ``flash_attention`` on the [B, H, N, D] views of the buffer (batch
    stride N*3*H*D, head stride D, row stride 3*H*D), which B3-B7 read
    with no transpose copy.  With no gradient to record, B1 runs as the
    custom op ``flash_fwd_packed_qkv_op`` (the module docstring says
    why)."""
    b, n, hd3 = qkv.shape
    hd = hd3 // 3
    d = _split_heads(hd, num_heads)
    scale = float(d ** -0.5 if scale is None else scale)
    if not no_max or d not in HEAD_DIMS:
        q, k, v, _, _ = _split_qkv(qkv, False)
        return flash_attention_packed(q, k, v, num_heads, scale=scale,
                                      no_max=no_max)
    cls = _cls_split(n)
    if torch.is_grad_enabled() and qkv.requires_grad:
        out, _ = FlashPackedQKV.apply(qkv, num_heads, scale, cls)
    else:
        out, _ = flash_fwd_packed_qkv_op(qkv, num_heads, scale, cls)
    if not cls:
        return out
    q, k, v, _, _ = _split_qkv(qkv, False)
    out_cls = _cls_query_row(_bhnd(q[:, :1], num_heads), _bhnd(k, num_heads),
                             _bhnd(v, num_heads), scale)
    return torch.cat([_packed(out_cls), out], dim=1)
