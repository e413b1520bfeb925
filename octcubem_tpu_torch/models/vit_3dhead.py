"""RETFound-all baseline: a 2D ViT over every slice and a 3D pooling head
(counterpart of octcubem_tpu/models/vit_3dhead.py).

Parity target: OCTCube/models_vit_3dhead_flash_attn.py:40-112: the 2D
trunk runs on the [B*N] slices, the slice features are mean-pooled, then
fc_aggregate_cls -> aggregate_cls_norm -> head.  The trunk defaults to
``parity="flash"`` and has no head of its own.  Input [B, N, H, W, C].
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import Dense, LayerNorm
from .vit2d import VisionTransformer2D


class VisionTransformer3DHead(nn.Module):
    def __init__(self, num_classes: int = 16, img_size: int = 224,
                 patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 drop_path_rate: float = 0.0, global_pool: bool = True,
                 parity: str = "flash", dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", remat: bool = False):
        super().__init__()
        self.depth = depth  # the flax module's field (layer decay reads it)
        self.trunk = VisionTransformer2D(
            img_size=img_size, patch_size=patch_size, in_chans=in_chans,
            num_classes=0, embed_dim=embed_dim, depth=depth,
            num_heads=num_heads, drop_path_rate=drop_path_rate,
            global_pool=global_pool, parity=parity, dtype=dtype,
            attn_impl=attn_impl, remat=remat)
        self.fc_aggregate_cls = Dense(embed_dim, embed_dim, compute_dtype=dtype)
        self.aggregate_cls_norm = LayerNorm(embed_dim)
        self.head = Dense(embed_dim, num_classes, compute_dtype=dtype)

    def forward_features(self, x, generator: torch.Generator | None = None):
        """x: [B, N, H, W, C] (N slices) -> [B, D]."""
        b, n, h, w, c = x.shape
        feat = self.trunk.forward_features(x.reshape(b * n, h, w, c),
                                           generator)
        feat = feat.reshape(b, n, -1).mean(dim=1)
        return self.aggregate_cls_norm(self.fc_aggregate_cls(feat))

    def forward(self, x, generator: torch.Generator | None = None):
        return self.head(self.forward_features(x, generator))

    def lock_groups(self) -> list[list[str]]:
        """The reference lock() groups (models_vit_3dhead_flash_attn.py:
        67-102), as JAX's, in state-dict name prefixes."""
        groups = [["trunk.patch_embed", "trunk.pos_embed", "trunk.cls_token"]]
        groups += [[f"trunk.blocks.{i}"] for i in range(self.depth - 1)]
        groups += [[f"trunk.blocks.{self.depth - 1}", "trunk.fc_norm",
                    "trunk.norm"]]
        groups += [["fc_aggregate_cls", "aggregate_cls_norm", "head"]]
        return groups


def vit_large_patch16(**kw) -> VisionTransformer3DHead:
    kw = {"depth": 24, "num_heads": 16, **kw}
    return VisionTransformer3DHead(patch_size=16, embed_dim=1024, **kw)


@torch.no_grad()
def _init(model: VisionTransformer3DHead, generator: torch.Generator):
    """flax's distributions, the trunk's by its own names."""
    from .vit_st import init_vit_param

    for name, p in model.named_parameters():
        init_vit_param(name.removeprefix("trunk."), p, generator)


def create_model(ctor=vit_large_patch16, device=None, seed: int = 0,
                 state_dict=None, **kw) -> VisionTransformer3DHead:
    """``ctor(**kw)`` on ``device`` (default cuda) in eval mode with seeded
    random weights, then ``state_dict`` imported over them."""
    from ..compat.torch_import import build_model

    return build_model(ctor, _init, device, seed, state_dict, **kw).eval()
