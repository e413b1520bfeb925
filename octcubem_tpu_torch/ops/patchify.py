"""Tube patchify / unpatchify and the tube patch embedding as reshape +
one matmul (channel-last volumes; counterpart of
octcubem_tpu/ops/patchify.py).

Conv3d with kernel == stride is a block reshape followed by a matmul;
like the JAX package, which leaves the einsum to XLA, the port emits the
matmul directly.  It does not call conv3d: cuDNN runs fp32 convolutions
in TF32 by default, a matmul on the card runs in full fp32.  Token order
is (t, h, w), within-patch order (u, p, q, c); weights keep the Conv3d
layout [D, C, t, p, p].
"""

from __future__ import annotations

import torch


def tube_embed(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None, t_patch: int,
               patch: int) -> torch.Tensor:
    """x: [B, T, H, W, C]; weight: the Conv3d layout [D, C, t, p, p];
    returns [B, t, h*w, D], tokens in (t, h, w) order, in x's dtype."""
    b, t, h, w, c = x.shape
    tt, hh, ww = t // t_patch, h // patch, w // patch
    d = weight.shape[0]
    x = x.reshape(b, tt, t_patch, hh, patch, ww, patch, c)
    # b t u h p w q c -> b t h w u p q c
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b * tt * hh * ww, -1)
    # [D, C, u, p, q] -> [u, p, q, C, D]
    kernel = weight.permute(2, 3, 4, 1, 0).reshape(-1, d).to(x.dtype)
    out = torch.matmul(x, kernel).reshape(b, tt, hh * ww, d)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def patchify_3d(x: torch.Tensor, t_patch: int, patch: int) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, t*h*w, t_patch*patch*patch*C] pixel patches."""
    b, t, h, w, c = x.shape
    if t % t_patch or h % patch or w % patch:
        raise ValueError(f"volume {tuple(x.shape)} is not a whole number of "
                         f"{t_patch}x{patch}x{patch} tubes")
    tt, hh, ww = t // t_patch, h // patch, w // patch
    x = x.reshape(b, tt, t_patch, hh, patch, ww, patch, c)
    # b t u h p w q c -> b t h w u p q c
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, tt * hh * ww, t_patch * patch * patch * c)


def unpatchify_3d(x: torch.Tensor, t_patch: int, patch: int,
                  grid: tuple[int, int, int], channels: int) -> torch.Tensor:
    """[B, t*h*w, t_patch*p*p*C] -> [B, T, H, W, C]; inverse of
    ``patchify_3d``."""
    b = x.shape[0]
    tt, hh, ww = grid
    x = x.reshape(b, tt, hh, ww, t_patch, patch, patch, channels)
    # b t h w u p q c -> b t u h p w q c
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, tt * t_patch, hh * patch, ww * patch, channels)


def tube_embed_tokens(patches: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor | None) -> torch.Tensor:
    """Embed already-patchified token rows: [B, K, t_patch*p*p*C] ->
    [B, K, D] in the patches' dtype; ``weight`` is the Conv3d layout
    [D, C, t, p, p].  Equal to gathering ``tube_embed``'s output rows (the
    MAE encoder embeds only its visible tokens)."""
    d = weight.shape[0]
    kernel = weight.permute(2, 3, 4, 1, 0).reshape(-1, d).to(patches.dtype)
    out = torch.matmul(patches, kernel)
    if bias is not None:
        out = out + bias.to(patches.dtype)
    return out
