"""Tube patch embedding as reshape + one matmul (channel-last volumes).

Conv3d with kernel == stride is a block reshape followed by a matmul;
like the JAX package, which leaves the einsum to XLA, the port emits the
matmul directly.  It does not call conv3d: cuDNN runs fp32 convolutions
in TF32 by default, a matmul on the card runs in full fp32.
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
