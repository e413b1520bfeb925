"""Multi-head attention ops: the naive reference path and the flash
dispatch (counterpart of octcubem_tpu/ops/attention.py).

``impl="auto"`` and ``"flash"`` both take the flash path, whose device
decides the rest: a CUDA tensor launches the kernels (B1 / B2 on the
packed layout, or B3-B5 / B7 on [B, H, N, D]), a CPU tensor runs their
plain versions (ops/flash_attention.py).  ``impl="naive"`` is the plain
softmax(QK^T)V with an fp32 softmax.  ``impl="flash_sp"`` is the
sequence-parallel path (parallel/sequence.py): the tensors are this
rank's token shard, and the ``use_sequence_parallel`` context gives the
mesh, the axis and the global valid length.  The JAX package pads a
length the sp degree does not divide inside this dispatch, on its global
arrays; a rank sees only its shard, so the pad happens where the
activations are sharded (``shard_sequence``), the context carries the
valid length, and the caller drops the pad rows.  The head-parallel
path (``"flash_tp"``) is not ported yet.
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
    if impl == "flash_tp":
        raise NotImplementedError(
            "attention impl 'flash_tp' (head-parallel attention with column- "
            "and row-parallel projections) is not ported yet (ROADMAP A14)")
    if impl not in ("auto", "flash", "naive", "flash_sp"):
        raise ValueError(f"unknown attention impl {impl!r}")


def _sp_attention(q, k, v, scale):
    """The flash_sp path on [B, H, n_loc, D] shards, from the context."""
    from ..parallel.sequence import current_sp, sequence_parallel_attention

    mesh, axis, batch_axis, n_valid = current_sp()
    return sequence_parallel_attention(q, k, v, mesh, axis, scale=scale,
                                       n_valid=n_valid, batch_axis=batch_axis)


def multi_head_attention(q, k, v, scale=None, impl: str = "auto"):
    """[B, H, N, D] dispatch: ``flash_attention``, the sequence-parallel
    path or the naive path."""
    _check_impl(impl)
    if impl == "naive":
        return naive_attention(q, k, v, scale=scale)
    if impl == "flash_sp":
        return _sp_attention(q, k, v, scale)
    return flash_attention(q, k, v, scale=scale)


def multi_head_attention_packed(q, k, v, num_heads: int, scale=None,
                                impl: str = "auto"):
    """Packed-head dispatch: q/k/v [B, N, H*D] -> [B, N, H*D]."""
    _check_impl(impl)
    if impl in ("auto", "flash"):
        return flash_attention_packed(q, k, v, num_heads, scale=scale)
    b, n, hd = q.shape
    d = hd // num_heads

    def bhnd(x):
        return x.reshape(b, n, num_heads, d).transpose(1, 2)

    if impl == "flash_sp":
        out = _sp_attention(bhnd(q), bhnd(k), bhnd(v), scale)
    else:
        out = naive_attention(bhnd(q), bhnd(k), bhnd(v), scale=scale)
    return out.transpose(1, 2).reshape(b, n, hd)


def multi_head_attention_qkv(qkv, num_heads: int, scale=None,
                             impl: str = "auto"):
    """Fused-projection dispatch: qkv [B, N, 3*H*D] straight from Wqkv.
    The flash path reads q/k/v out of the fused buffer in the kernel;
    the naive and sequence-parallel paths slice and delegate."""
    _check_impl(impl)
    if impl in ("auto", "flash"):
        return flash_attention_packed_qkv(qkv, num_heads, scale=scale)
    hd = qkv.shape[-1] // 3
    q, k, v = (qkv[..., i * hd:(i + 1) * hd] for i in range(3))
    return multi_head_attention_packed(q, k, v, num_heads, scale=scale,
                                       impl=impl)
