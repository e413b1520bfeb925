"""2D ViT classifier, the RETFound-style baseline (counterpart of
octcubem_tpu/models/vit2d.py).

Parity targets: OCTCube/models_vit.py (timm VisionTransformer with global
pool and fc_norm on the center B-scan) and models_vit_flash_attn.py: a
flat learned pos embed with a cls token, ``parity="standard"`` by default
(the timm checkpoints) and ``"flash"`` for the flash-attn ones.  With
``global_pool`` the model has ``fc_norm`` and no ``norm`` (models_vit.py
deletes it), without it ``norm`` only, so a checkpoint holds exactly one
of the two.  ``num_classes=0``: no head, the forward returns the feature.
Input [B, H, W, C] channel-last.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import Dense, LayerNorm, TransformerStack
from ..nn.patch_embed import PatchEmbed2D
from .vit_st import init_params


class VisionTransformer2D(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_chans: int = 3, num_classes: int = 0,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rate: float = 0.0, global_pool: bool = True,
                 parity: str = "standard", capture_cam: bool = False,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 remat: bool = False, quant: bool = False):
        super().__init__()
        self.embed_dim = embed_dim
        self.depth = depth  # the flax module's field (layer decay reads it)
        self.global_pool = global_pool
        self.num_classes = num_classes
        self.patch_embed = PatchEmbed2D(img_size, patch_size, in_chans,
                                        embed_dim, dtype=dtype)
        n = self.patch_embed.num_patches + 1
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n, embed_dim))
        self.blocks = TransformerStack(
            depth, embed_dim, num_heads, mlp_ratio, qkv_bias, drop_path_rate,
            dtype=dtype, attn_impl=attn_impl, parity=parity, remat=remat,
            quant=quant, capture_cam=capture_cam)
        if global_pool:
            self.fc_norm = LayerNorm(embed_dim)
        else:
            self.norm = LayerNorm(embed_dim)
        if num_classes > 0:
            self.head = Dense(embed_dim, num_classes, compute_dtype=dtype)

    def forward_features(self, x, generator: torch.Generator | None = None):
        """x: [B, H, W, C] -> [B, D] (fp32, out of the final LayerNorm)."""
        b = x.shape[0]
        x = self.patch_embed(x)
        cls = self.cls_token.to(x.dtype).expand(b, 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        x = self.blocks(x, generator)
        if self.global_pool:
            return self.fc_norm(x[:, 1:, :].mean(dim=1))
        return self.norm(x)[:, 0]

    def forward(self, x, generator: torch.Generator | None = None):
        feat = self.forward_features(x, generator)
        return self.head(feat) if self.num_classes > 0 else feat


# depth and num_heads are overridable, to cut a model for a test

def vit_large_patch16(**kw) -> VisionTransformer2D:
    kw = {"depth": 24, "num_heads": 16, **kw}
    return VisionTransformer2D(patch_size=16, embed_dim=1024, **kw)


def vit_base_patch16(**kw) -> VisionTransformer2D:
    kw = {"depth": 12, "num_heads": 12, **kw}
    return VisionTransformer2D(patch_size=16, embed_dim=768, **kw)


def vit_huge_patch14(**kw) -> VisionTransformer2D:
    kw = {"depth": 32, "num_heads": 16, **kw}
    return VisionTransformer2D(patch_size=14, embed_dim=1280, **kw)


def create_model(ctor=vit_large_patch16, device=None, seed: int = 0,
                 state_dict=None, **kw) -> VisionTransformer2D:
    """``ctor(**kw)`` on ``device`` (default cuda) in eval mode with
    seeded random weights (flax's distributions), then ``state_dict``
    imported over them (``compat.torch_import.build_model``)."""
    from ..compat.torch_import import build_model

    return build_model(ctor, init_params, device, seed, state_dict,
                       **kw).eval()
