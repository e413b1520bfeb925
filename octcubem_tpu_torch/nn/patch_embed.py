"""Tube patch embedding module (counterpart of octcubem_tpu/nn/patch_embed.py).

Parameters keep the reference Conv3d layout, ``proj.weight``
[D, C, t, p, p] and ``proj.bias`` [D], so reference checkpoints load
with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.patchify import tube_embed


class _Proj(nn.Module):
    """Holds the Conv3d-layout parameters; the forward is a matmul."""

    def __init__(self, embed_dim: int, in_chans: int, t_patch: int,
                 patch: int):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(embed_dim, in_chans, t_patch, patch, patch))
        self.bias = nn.Parameter(torch.zeros(embed_dim))


class PatchEmbed3D(nn.Module):
    """[B, T, H, W, C] -> [B, t, h*w, D] tube patch embedding in ``dtype``."""

    def __init__(self, img_size: int, patch_size: int, in_chans: int,
                 embed_dim: int, frames: int, t_patch_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.t_patch_size = t_patch_size
        self.grid_size = img_size // patch_size
        self.t_grid_size = frames // t_patch_size
        self.num_patches = self.t_grid_size * self.grid_size ** 2
        self.dtype = dtype
        self.proj = _Proj(embed_dim, in_chans, t_patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] != self.img_size or x.shape[3] != self.img_size:
            raise ValueError(f"input {x.shape[2]}x{x.shape[3]} != model "
                             f"{self.img_size}")
        return tube_embed(x.to(self.dtype), self.proj.weight, self.proj.bias,
                          self.t_patch_size, self.patch_size)
