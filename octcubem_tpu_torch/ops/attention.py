"""Multi-head attention ops: the naive reference path and the flash
dispatch (counterpart of octcubem_tpu/ops/attention.py).

``impl="auto"`` and ``"flash"`` both take the flash path, whose device
decides the rest: a CUDA tensor launches the kernels (B1 / B2 on the
packed layout, or B3-B5 / B7 on [B, H, N, D]), a CPU tensor runs their
plain versions (ops/flash_attention.py).  ``impl="naive"`` is the plain
softmax(QK^T)V with an fp32 softmax.  The sequence- and head-parallel
paths are not ported yet.
"""

from __future__ import annotations

import torch

from .flash_attention import (flash_attention, flash_attention_packed,
                              flash_attention_packed_qkv)


def naive_attention(q, k, v, scale: float | None = None):
    """q, k, v: [B, H, N, D] -> [B, H, N, D].  fp32 softmax."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _check_impl(impl: str) -> None:
    if impl in ("flash_sp", "flash_tp"):
        raise NotImplementedError(
            f"attention impl {impl!r} (sequence/head parallel) is not "
            "ported yet (ROADMAP A14)")
    if impl not in ("auto", "flash", "naive"):
        raise ValueError(f"unknown attention impl {impl!r}")


def multi_head_attention(q, k, v, scale=None, impl: str = "auto"):
    """[B, H, N, D] dispatch: ``flash_attention`` or the naive path."""
    _check_impl(impl)
    if impl == "naive":
        return naive_attention(q, k, v, scale=scale)
    return flash_attention(q, k, v, scale=scale)


def multi_head_attention_packed(q, k, v, num_heads: int, scale=None,
                                impl: str = "auto"):
    """Packed-head dispatch: q/k/v [B, N, H*D] -> [B, N, H*D]."""
    _check_impl(impl)
    if impl != "naive":
        return flash_attention_packed(q, k, v, num_heads, scale=scale)
    b, n, hd = q.shape
    d = hd // num_heads

    def bhnd(x):
        return x.reshape(b, n, num_heads, d).transpose(1, 2)

    out = naive_attention(bhnd(q), bhnd(k), bhnd(v), scale=scale)
    return out.transpose(1, 2).reshape(b, n, hd)


def multi_head_attention_qkv(qkv, num_heads: int, scale=None,
                             impl: str = "auto"):
    """Fused-projection dispatch: qkv [B, N, 3*H*D] straight from Wqkv.
    The flash path reads q/k/v out of the fused buffer in the kernel;
    the naive path slices and delegates."""
    _check_impl(impl)
    if impl != "naive":
        return flash_attention_packed_qkv(qkv, num_heads, scale=scale)
    hd = qkv.shape[-1] // 3
    q, k, v = (qkv[..., i * hd:(i + 1) * hd] for i in range(3))
    return multi_head_attention_packed(q, k, v, num_heads, scale=scale,
                                       impl=impl)
