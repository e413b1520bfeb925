"""Random tube masking for MAE pretraining (counterpart of
octcubem_tpu/ops/masking.py).

The JAX function draws its uniform noise from a key inside the module;
here the caller passes the noise [B, L] (from a ``torch.Generator``, or
the JAX package's own noise in the parity tests), so the two packages can
be compared.  The rest is the JAX algorithm: a stable argsort of the
noise, the first ``int(L * (1 - mask_ratio))`` tokens kept (the same
Python float expression, so 5,120 tokens at mask 0.90 keep 511), the
inverse permutation by scatter, and the blank-region ``pre_mask`` folded
into the sort key (+1, so pre-masked tokens sort last and are always
masked).  mask_ratio == 0 is the identity permutation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MaskingResult(NamedTuple):
    ids_keep: torch.Tensor     # [B, len_keep] indices of visible tokens
    ids_restore: torch.Tensor  # [B, L] inverse shuffle permutation
    mask: torch.Tensor         # [B, L] fp32, 0 = keep, 1 = masked


def keep_count(length: int, mask_ratio: float) -> int:
    """Visible tokens of ``length`` at ``mask_ratio``: int(L * (1 - r)),
    as in the JAX package and the reference."""
    return int(length * (1 - mask_ratio))


def random_masking(noise: torch.Tensor, length: int, mask_ratio: float,
                   pre_mask: torch.Tensor | None = None) -> MaskingResult:
    """Per-sample random masking by argsort of ``noise`` [B, length]
    (uniform in [0, 1)).  With mask_ratio == 0 only noise's batch size and
    device are used."""
    b = noise.shape[0]
    if noise.shape != (b, length):
        raise ValueError(f"noise {tuple(noise.shape)} != [B, {length}]")
    len_keep = keep_count(length, mask_ratio)
    pos = torch.arange(length, device=noise.device)
    if mask_ratio > 0:
        key = noise.float()
    else:
        key = pos.float().expand(b, length)
    if pre_mask is not None:
        key = key + (pre_mask > 0).to(key.dtype)
    ids_shuffle = torch.argsort(key, dim=1, stable=True)
    ids_restore = torch.empty_like(ids_shuffle).scatter_(
        1, ids_shuffle, pos.expand(b, length))
    mask = torch.ones((b, length), dtype=torch.float32, device=noise.device)
    mask[:, :len_keep] = 0.0
    mask = torch.gather(mask, 1, ids_restore)
    return MaskingResult(ids_shuffle[:, :len_keep], ids_restore, mask)


def gather_tokens(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather tokens [B, L, D] by per-sample indices [B, K] -> [B, K, D]."""
    return torch.gather(x, 1, ids[..., None].expand(-1, -1, x.shape[-1]))


def permute_tokens(x: torch.Tensor, ids: torch.Tensor,
                   ids_inv: torch.Tensor) -> torch.Tensor:
    """[B, L, D] reordered by the permutation ids [B, L].  ``ids_inv`` (its
    inverse) fed the JAX custom VJP, a TPU scatter workaround; autograd's
    gather backward needs it not, so it is only checked for shape."""
    if ids_inv.shape != ids.shape:
        raise ValueError("ids_inv must have the permutation's shape")
    return gather_tokens(x, ids)


def gather_keep_tokens(x: torch.Tensor, ids_keep: torch.Tensor,
                       ids_restore: torch.Tensor) -> torch.Tensor:
    """[B, L, D] -> [B, K, D], the visible-token gather.  ``ids_restore``
    fed the JAX custom VJP; autograd's gather backward needs it not."""
    if ids_restore.shape != (x.shape[0], x.shape[1]):
        raise ValueError("ids_restore must be [B, L]")
    return gather_tokens(x, ids_keep)
