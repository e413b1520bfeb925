"""The plain reference's building blocks: float32 PyTorch operations on a
dict of named tensors, with TF32 off, importing nothing of the program.

They follow the published OCTCube flash-attn ViT (the reference
repository's ``models_vit_st_flash_attn.py`` and its MAE): pre-norm
blocks with a fused q/k/v projection, exact-erf GELU, LayerNorm eps 1e-6,
and the flash-attn two-stream block, whose stack returns the last block's
MLP branch without the final residual add.  The attention here is the
plain softmax; the program's kernels shift the logits by a fixed 16 and
clamp them at 40 before the exp, which is the same function wherever a
logit stays under 40.

``Precision`` is where the control differs from the reference: ``"fp32"``
multiplies in float32; ``"fp8"`` rounds both operands of every product
(projections, patch embeddings and both attention products) to float8
e4m3 with one scale a tensor (its largest magnitude at the format's
largest), and the gradient reaching each operand to float8 e5m2 the same
way, then multiplies in float32: the float8 training recipe, the step
below the configuration's bfloat16 that a later change could be tempted
to take.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def _round8(t, dtype):
    """t rounded to a float8 ``dtype`` with one scale for the tensor."""
    if t.numel() == 0:
        return t
    top = torch.finfo(dtype).max
    s = top / t.detach().abs().amax().clamp(min=1e-30)
    return (t * s).to(dtype).to(t.dtype) / s


class _Fp8(torch.autograd.Function):
    """e4m3 forward, e5m2 gradient, each with a tensor's own scale."""

    @staticmethod
    def forward(ctx, t):
        return _round8(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Precision:
    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, t):
        """An operand of a product as this precision holds it."""
        return t if self.name == "fp32" else _Fp8.apply(t)

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).T
        return y if b is None else y + b

    def matmul(self, a, b):
        return self.q(a) @ self.q(b)


def layer_norm(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, LN_EPS)


def attention(qkv, heads: int, P: Precision):
    """Fused [B, N, 3*H*D] -> [B, N, H*D]: q, k and v are the three column
    blocks, head h at columns h*D of each."""
    b, n, hd3 = qkv.shape
    hd = hd3 // 3
    d = hd // heads

    def split(t):
        return t.reshape(b, n, heads, d).transpose(1, 2)

    q, k, v = (split(qkv[..., i * hd:(i + 1) * hd]) for i in range(3))
    s = P.matmul(q, k.transpose(-1, -2)) * d ** -0.5
    p = torch.softmax(s, dim=-1)
    return P.matmul(p, v).transpose(1, 2).reshape(b, n, hd)


def block(p, pre: str, x, heads: int, P: Precision):
    """One two-stream block -> (x + a + m, m)."""
    h = layer_norm(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"])
    qkv = P.linear(h, p[pre + "mixer.Wqkv.weight"], p[pre + "mixer.Wqkv.bias"])
    a = P.linear(attention(qkv, heads, P), p[pre + "mixer.out_proj.weight"],
                 p[pre + "mixer.out_proj.bias"])
    x = x + a
    h = layer_norm(x, p[pre + "norm2.weight"], p[pre + "norm2.bias"])
    h = F.gelu(P.linear(h, p[pre + "mlp.fc1.weight"], p[pre + "mlp.fc1.bias"]))
    m = P.linear(h, p[pre + "mlp.fc2.weight"], p[pre + "mlp.fc2.bias"])
    return x + m, m


def stack(p, pre: str, x, depth: int, heads: int, P: Precision,
          first: int = 0, checkpoint: bool = False):
    """Blocks ``first`` .. depth-1 of the stack under ``pre`` -> (hidden,
    the last block's MLP branch).  ``checkpoint`` recomputes each block in
    the backward, to bound the memory of a long sequence."""
    m = x
    for i in range(first, depth):
        fn = lambda t, i=i: block(p, f"{pre}{i}.", t, heads, P)  # noqa: E731
        if checkpoint and torch.is_grad_enabled():
            x, m = torch.utils.checkpoint.checkpoint(fn, x,
                                                     use_reentrant=False)
        else:
            x, m = fn(x)
    return x, m


def tube_patches(x, t_patch: int, patch: int):
    """[B, T, H, W, C] -> [B, t*h*w, t_patch*patch*patch*C], tokens in
    (t, h, w) order, each patch in (u, p, q, c) order."""
    b, t, h, w, c = x.shape
    x = x.reshape(b, t // t_patch, t_patch, h // patch, patch, w // patch,
                  patch, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, -1, t_patch * patch * patch * c)


def tube_kernel(weight):
    """A Conv3d kernel [D, C, t, p, p] as the matrix [D, t*p*p*C] that
    ``tube_patches`` rows multiply."""
    return weight.permute(0, 2, 3, 4, 1).reshape(weight.shape[0], -1)


def image_patches(x, patch: int):
    """[B, H, W, C] -> [B, h*w, p*p*C], tokens in (h, w) order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // patch, patch, w // patch, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, patch * patch * c)


def image_kernel(weight):
    """A Conv2d kernel [D, C, p, p] as the matrix [D, p*p*C]."""
    return weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1)


def pooled_spatial(pos, grid: int):
    """A learned spatial table [1, g*g, D] stored at another grid, resized
    to ``grid`` x ``grid`` by bicubic interpolation (the reference's
    ``F.interpolate(mode="bicubic", align_corners=False)``)."""
    g = math.isqrt(pos.shape[1])
    if g == grid:
        return pos
    d = pos.shape[-1]
    t = pos.reshape(1, g, g, d).permute(0, 3, 1, 2)
    t = F.interpolate(t, size=(grid, grid), mode="bicubic",
                      align_corners=False)
    return t.permute(0, 2, 3, 1).reshape(1, grid * grid, d)


def sep_pos(spatial, temporal, grid: int):
    """Separable pos embeds for (t, h, w) tokens: the spatial table tiled
    over t plus the temporal one repeated over h*w -> [1, t*g*g, D]."""
    spat = pooled_spatial(spatial, grid)
    t = temporal.shape[1]
    return spat.repeat(1, t, 1) + temporal.repeat_interleave(grid * grid,
                                                              dim=1)
