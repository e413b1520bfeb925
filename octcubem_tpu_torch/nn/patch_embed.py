"""Patch embedding modules (counterpart of octcubem_tpu/nn/patch_embed.py).

Parameters keep the reference layouts, Conv3d ``proj.weight``
[D, C, t, p, p] (tube patches) and Conv2d ``proj.weight`` [D, C, p, p]
(2D patches), with ``proj.bias`` [D], so reference checkpoints load with
``load_state_dict(strict=True)``.  The forwards are a block reshape and
one matmul (ops/patchify.py says why).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.patchify import tube_embed


class _Proj(nn.Module):
    """Holds the Conv3d-layout parameters (Conv2d's with ``t_patch``
    None); the forward is a matmul."""

    def __init__(self, embed_dim: int, in_chans: int, t_patch: int | None,
                 patch: int):
        super().__init__()
        tube = () if t_patch is None else (t_patch,)
        self.weight = nn.Parameter(
            torch.empty(embed_dim, in_chans, *tube, patch, patch))
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


class PatchEmbed2D(nn.Module):
    """[B, H, W, C] channel-last -> [B, h*w, D] patch embedding in
    ``dtype`` (a Conv2d with kernel == stride); tokens in (h, w) order,
    within-patch order (p, q, c)."""

    def __init__(self, img_size: int, patch_size: int, in_chans: int,
                 embed_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.grid_size = img_size // patch_size
        self.num_patches = self.grid_size ** 2
        self.dtype = dtype
        self.proj = _Proj(embed_dim, in_chans, None, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        p = self.patch_size
        hh, ww = h // p, w // p
        d = self.proj.weight.shape[0]
        x = x.to(self.dtype).reshape(b, hh, p, ww, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b * hh * ww, p * p * c)
        # [D, C, p, q] -> [p, q, C, D]
        kernel = self.proj.weight.permute(2, 3, 1, 0).reshape(-1, d)
        out = torch.matmul(x, kernel.to(x.dtype)).reshape(b, hh * ww, d)
        return out + self.proj.bias.to(x.dtype)
