"""Sine-cosine positional embeddings and grid interpolation (counterpart
of octcubem_tpu/ops/pos_embed.py).

The tables are generated in numpy (float32, the JAX package's steps, so
they are equal to the bit); the interpolations are ops/resize.py's
matrix products on torch tensors.

``sincos_2d`` keeps the JAX package's layout: the h-mesh half first,
then the w-mesh half.  The upstream PyTorch code (the MAE's
``get_2d_sincos_pos_embed``) puts the w-mesh half first; the port holds
to the JAX package, its reference, so a table made here equals the JAX
one and not the upstream one.
"""

from __future__ import annotations

import numpy as np
import torch

from .resize import resize_grid_bicubic, resize_seq_linear


def sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """[M] positions -> [M, embed_dim] sincos embedding."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim {embed_dim} is odd")
    omega = np.arange(embed_dim // 2, dtype=np.float32) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float32), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(embed_dim: int, grid_size: int,
              cls_token: bool = False) -> np.ndarray:
    """[grid*grid (+1), embed_dim] 2D sincos embedding: the h-mesh half,
    then the w-mesh half (see the module docstring); a zero cls row first
    when ``cls_token``."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim {embed_dim} is odd")
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    # w varies fastest, as np.meshgrid(grid_w, grid_h) in the reference
    ww, hh = np.meshgrid(grid_w, grid_h)
    emb_h = sincos_1d(embed_dim // 2, hh)
    emb_w = sincos_1d(embed_dim // 2, ww)
    emb = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros([1, embed_dim], dtype=np.float32),
                              emb], axis=0)
    return emb


def interpolate_spatial_pos_embed(pos: torch.Tensor,
                                  old_grid: tuple[int, int],
                                  new_grid: tuple[int, int],
                                  num_extra_tokens: int = 0) -> torch.Tensor:
    """Bicubic-resize a flattened [1, extra + H*W, D] spatial pos embed;
    the extra (cls) tokens pass through unchanged."""
    if tuple(old_grid) == tuple(new_grid):
        return pos
    extra = pos[:, :num_extra_tokens]
    grid = pos[:, num_extra_tokens:].reshape(pos.shape[0], *old_grid,
                                             pos.shape[-1])
    grid = resize_grid_bicubic(grid, new_grid)
    grid = grid.reshape(pos.shape[0], new_grid[0] * new_grid[1],
                        pos.shape[-1])
    return torch.cat([extra, grid], dim=1)


def interpolate_temporal_pos_embed(pos: torch.Tensor, new_len: int,
                                   smaller_interpolate_type: str = "interp"
                                   ) -> torch.Tensor:
    """[1, T, D] -> [1, T', D]: linear, or the middle crop when shrinking
    with ``smaller_interpolate_type='crop'``."""
    t = pos.shape[-2]
    if t == new_len:
        return pos
    if t > new_len and smaller_interpolate_type == "crop":
        start = (t - new_len) // 2
        return pos[:, start:start + new_len]
    return resize_seq_linear(pos, new_len)


def build_sep_pos_embed(pos_spatial: torch.Tensor, pos_temporal: torch.Tensor,
                        stored_grid: tuple[int, int],
                        target_grid: tuple[int, int], t_grid: int,
                        pos_class: torch.Tensor | None = None,
                        use_temporal: bool = True) -> torch.Tensor:
    """Separable spatial [1, Hs*Ws, D] + temporal [1, T, D] pos embeds ->
    a token-aligned [1, (1+) T*L, D] embedding, the spatial grid
    bicubic-pooled when the stored grid is not the target.  Tokens are
    (t, h, w): the spatial table tiles over t, the temporal one repeats
    over h*w.  ``use_temporal=False`` (2D inputs) adds no temporal
    term."""
    d = pos_spatial.shape[-1]
    spat = interpolate_spatial_pos_embed(pos_spatial, stored_grid,
                                         target_grid)
    l = target_grid[0] * target_grid[1]
    if use_temporal:
        pos = (spat.repeat(1, t_grid, 1)
               + torch.repeat_interleave(pos_temporal, l, dim=1))
    else:
        pos = spat
    if pos_class is not None:
        pos = torch.cat([pos_class, pos], dim=1)
    return pos.reshape(1, -1, d)
