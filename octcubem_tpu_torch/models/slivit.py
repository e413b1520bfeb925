"""SLIViT: a ConvNeXt-tiny slice feature extractor and a compact ViT over
the per-slice feature maps (counterpart of octcubem_tpu/models/slivit.py).

Parity targets:
- OCTCube/model_slivit_baseline.py:18-92: the slices stacked into one tall
  image -> ConvNeXt-tiny trunk (final LayerNorm dropped) -> features
  reshaped to [B, N, 768*64] tokens -> a vit-pytorch ViT (dim 256, depth
  5, 20 heads of 64, mlp 512) with the integer-arange positional
  embedding and cls pooling;
- OCTCube/models_slivit_head.py: the same ViT head on an OCTCube ViT-ST
  trunk (models_vit_st_flash_attn_slivit.py).

ConvNeXt-tiny is written natively, as JAX's is (no downloaded weights):
channel-last at the module boundary, a depthwise 7x7 conv, LayerNorm
(eps 1e-6), a pointwise MLP with exact GELU and a layer scale.  The head's
LayerNorms use eps 1e-5, and its attention is a plain softmax over
``torch.matmul`` products: JAX computes it outside any Pallas kernel, and
the flash kernels' fixed-shift softmax would be another function.  The
ViT-ST trunk's attention runs the port's kernels (B1 / B2 on the card).

Parameter names are what ``compat.jax_params.state_dict_from_jax`` gives
JAX's tree (``feature_extractor.stage0_block0.dwconv.weight``,
``vit.blocks_0_to_qkv.weight``, ``head.blocks_0_to_qkv.weight``,
``trunk.blocks.0.*``), convolutions in PyTorch's [Cout, Cin/groups, kh,
kw] layout.  So layer decay reads them as JAX reads its paths: only the
trunk's ``blocks.N.`` are blocks, and everything else takes the head's
scale.  The dtype flow is flax's: LayerNorms compute and return fp32,
convolutions and Dense layers run in the compute dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Dense, LayerNorm


class Conv2d(nn.Module):
    """A conv holding PyTorch-layout ``weight`` [Cout, Cin/groups, k, k] and
    ``bias``, run in ``compute_dtype`` on a channel-last input:
    [B, H, W, Cin] -> [B, H', W', Cout]."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, groups: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding, self.groups = stride, padding, groups
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
                     self.bias.to(dt), self.stride, self.padding, 1,
                     self.groups)
        return y.permute(0, 2, 3, 1)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_scale_init = layer_scale_init
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim,
                             compute_dtype=dtype)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Dense(dim, 4 * dim, compute_dtype=dtype)
        self.pwconv2 = Dense(4 * dim, dim, compute_dtype=dtype)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x):
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(self.dwconv(x)))))
        return x + y * self.gamma.to(y.dtype)


class ConvNeXtTiny(nn.Module):
    """[B, H, W, 3] -> [B, H/32, W/32, dims[-1]] (no final LayerNorm, as the
    reference's trunk drops it)."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.stem_conv = Conv2d(3, dims[0], 4, stride=4, compute_dtype=dtype)
        self.stem_norm = LayerNorm(dims[0], eps=1e-6)
        for stage, (depth, dim) in enumerate(zip(depths, dims)):
            if stage > 0:
                self.add_module(f"downsample_norm_{stage}",
                                LayerNorm(dims[stage - 1], eps=1e-6))
                self.add_module(f"downsample_conv_{stage}",
                                Conv2d(dims[stage - 1], dim, 2, stride=2,
                                       compute_dtype=dtype))
            for blk in range(depth):
                self.add_module(f"stage{stage}_block{blk}",
                                ConvNeXtBlock(dim, dtype=dtype))

    def forward(self, x):
        x = self.stem_norm(self.stem_conv(x))
        for stage, depth in enumerate(self.depths):
            if stage > 0:
                x = getattr(self, f"downsample_norm_{stage}")(x)
                x = getattr(self, f"downsample_conv_{stage}")(x)
            for blk in range(depth):
                x = getattr(self, f"stage{stage}_block{blk}")(x)
        return x


class SLIViTHead(nn.Module):
    """vit-pytorch-style compact ViT over N feature 'patch' tokens:
    [B, N, patch_dim] -> logits [B, num_classes].  The positional
    embedding is the reference's integer arange (token i gets the constant
    vector i) unless ``rnd_pos_emb``."""

    def __init__(self, num_patches: int, patch_dim: int, num_classes: int = 1,
                 dim: int = 256, depth: int = 5, heads: int = 20,
                 dim_head: int = 64, mlp_dim: int = 512,
                 rnd_pos_emb: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_patches, self.dim, self.depth = num_patches, dim, depth
        self.heads, self.dim_head = heads, dim_head
        self.rnd_pos_emb = rnd_pos_emb
        inner = heads * dim_head
        self.patch_norm1 = LayerNorm(patch_dim, eps=1e-5)
        self.patch_proj = Dense(patch_dim, dim, compute_dtype=dtype)
        self.patch_norm2 = LayerNorm(dim, eps=1e-5)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        if rnd_pos_emb:
            self.pos_embedding = nn.Parameter(
                torch.zeros(1, num_patches + 1, dim))
        for i in range(depth):
            for name, mod in (
                    ("attn_norm", LayerNorm(dim, eps=1e-5)),
                    ("to_qkv", Dense(dim, 3 * inner, bias=False,
                                     compute_dtype=dtype)),
                    ("to_out", Dense(inner, dim, compute_dtype=dtype)),
                    ("mlp_norm", LayerNorm(dim, eps=1e-5)),
                    ("mlp_fc1", Dense(dim, mlp_dim, compute_dtype=dtype)),
                    ("mlp_fc2", Dense(mlp_dim, dim, compute_dtype=dtype))):
                self.add_module(f"blocks_{i}_{name}", mod)
        self.final_norm = LayerNorm(dim, eps=1e-5)
        self.mlp_head = Dense(dim, num_classes, compute_dtype=dtype)

    def _block(self, i: int, name: str):
        return getattr(self, f"blocks_{i}_{name}")

    def forward(self, tokens):
        b = tokens.shape[0]
        x = self.patch_norm2(self.patch_proj(self.patch_norm1(tokens.float())))
        cls = self.cls_token.to(x.dtype).expand(b, 1, self.dim)
        x = torch.cat([cls, x], dim=1)
        if self.rnd_pos_emb:
            pos = self.pos_embedding
        else:
            pos = torch.arange(self.num_patches + 1, dtype=torch.float32,
                               device=x.device)[None, :, None].expand(
                                   1, self.num_patches + 1, self.dim)
        x = x + pos.to(x.dtype)
        h_, d_ = self.heads, self.dim_head
        for i in range(self.depth):
            h = self._block(i, "attn_norm")(x)
            qkv = self._block(i, "to_qkv")(h).reshape(b, -1, 3, h_, d_)
            q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
            # scores in fp32 from the compute-dtype q and k (exact products,
            # fp32 sums), as JAX's preferred_element_type=float32
            s = torch.matmul(q.float(), k.float().transpose(-1, -2))
            p = torch.softmax(s * d_ ** -0.5, dim=-1)
            ctx = torch.matmul(p.to(v.dtype), v)
            ctx = ctx.transpose(1, 2).reshape(b, -1, h_ * d_)
            x = x + self._block(i, "to_out")(ctx)
            h = self._block(i, "mlp_norm")(x)
            h = self._block(i, "mlp_fc2")(F.gelu(self._block(i, "mlp_fc1")(h)))
            x = x + h
        x = self.final_norm(x)[:, 0]
        return self.mlp_head(x)


class ViTSTWithSLIViTHead(nn.Module):
    """OCTCube (ViT-ST) backbone + SLIViT head
    (models_vit_st_flash_attn_slivit.py:85-260): the backbone's last
    block's feature (its MLP branch under flash parity), cls dropped,
    regrouped per temporal slab [B, T', C, L] -> [B, T', C*L], into the
    compact ViT.  The trunk is a ``VisionTransformerST`` run up to its
    blocks: its final norm and heads are never run, and JAX's tree holds
    none of them, so they are not built here."""

    def __init__(self, num_classes: int = 1, trunk_kwargs: dict | None = None,
                 slivit_depth: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        from .vit_st import VisionTransformerST

        kw = dict(trunk_kwargs or {})
        kw.setdefault("cls_embed", True)
        kw.setdefault("global_pool", True)
        trunk = VisionTransformerST(num_classes=1, dtype=dtype, **kw)
        for name in ("norm", "fc_aggregate_cls", "aggregate_cls_norm", "head"):
            if hasattr(trunk, name):
                delattr(trunk, name)
        self.trunk = trunk
        self.patch_size = trunk.patch_size
        self.t_grid = trunk.num_frames // trunk.t_patch_size
        l = (trunk.patch_embed.img_size // trunk.patch_size) ** 2
        d = trunk.patch_embed.proj.weight.shape[0]
        self.head = SLIViTHead(num_patches=self.t_grid, patch_dim=d * l,
                               num_classes=num_classes, depth=slivit_depth,
                               dtype=dtype)

    def forward(self, x, generator: torch.Generator | None = None):
        tokens = self.trunk.forward_features(x, generator,
                                             return_hidden=True)[-1]
        if self.trunk.cls_embed:
            tokens = tokens[:, 1:]
        b, tl, d = tokens.shape
        l = tl // self.t_grid
        tok = tokens.reshape(b, self.t_grid, l, d).transpose(2, 3)
        return self.head(tok.reshape(b, self.t_grid, d * l))


class SLIViT(nn.Module):
    """The baseline: [B, N, H, W, C] slices -> logits.  The slices are
    stacked into one tall image before the ConvNeXt trunk, so receptive
    fields cross slice boundaries as in the reference's tall-image form
    (model_slivit_baseline.py:44-49); the features flatten to tokens in
    (c, h, w) order, as the reference's Rearrange."""

    def __init__(self, num_patches: int = 20, num_classes: int = 1,
                 slice_size: int = 256, vit_depth: int = 5,
                 convnext_depths: Sequence[int] = (3, 3, 9, 3),
                 convnext_dims: Sequence[int] = (96, 192, 384, 768),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_patches = num_patches
        self.feature_extractor = ConvNeXtTiny(convnext_depths, convnext_dims,
                                              dtype)
        per = slice_size // 32
        self.vit = SLIViTHead(num_patches=num_patches,
                              patch_dim=convnext_dims[-1] * per * per,
                              num_classes=num_classes, depth=vit_depth,
                              dtype=dtype)

    def forward(self, x, generator: torch.Generator | None = None):
        b, n, h, w, c = x.shape
        if n != self.num_patches:
            raise ValueError(f"{n} slices, the model takes {self.num_patches}")
        if c == 1:
            x = x.expand(b, n, h, w, 3)
        feat = self.feature_extractor(x.reshape(b, n * h, w, 3))
        fh, fw, fc = feat.shape[1:]
        per = fh // n
        tok = feat.reshape(b, n, per, fw, fc).permute(0, 1, 4, 2, 3)
        return self.vit(tok.reshape(b, n, fc * per * fw))


# ---- constructor registry (reference models_*.__dict__[name] pattern) ----

def slivit_baseline(*, num_classes=1, num_frames=20, img_size=256,
                    slivit_depth=5, convnext_depths=(3, 3, 9, 3),
                    convnext_dims=(96, 192, 384, 768),
                    dtype=torch.float32) -> SLIViT:
    """The standalone SLIViT baseline (model_slivit_baseline.py:18-92);
    num_frames = N slices taken from the volume (--slivit_slices)."""
    return SLIViT(num_patches=num_frames, num_classes=num_classes,
                  slice_size=img_size, vit_depth=slivit_depth,
                  convnext_depths=tuple(convnext_depths),
                  convnext_dims=tuple(convnext_dims), dtype=dtype)


def vit_large_patch16_slivit(*, num_classes=1, slivit_depth=5,
                             dtype=torch.float32, **trunk_kw):
    """OCTCube ViT-L trunk + SLIViT head (models_vit_st_flash_attn_slivit.py
    vit_large_patch16 with slivit_depth_num)."""
    trunk = dict(patch_size=16, embed_dim=1024, depth=24, num_heads=16)
    trunk.update(trunk_kw)
    return ViTSTWithSLIViTHead(num_classes=num_classes, trunk_kwargs=trunk,
                               slivit_depth=slivit_depth, dtype=dtype)


flash_attn_vit_large_patch16_slivit = vit_large_patch16_slivit


# ---- seeded initialisation (the flax initialisers' distributions) ----

@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator):
    """flax's defaults: lecun truncated-normal conv and Dense kernels, zero
    biases, unit LayerNorm scales, the layer scale at its init value,
    N(0, 0.02) cls tokens and learned pos embeddings; a ViT-ST trunk's
    params by its own rules (``vit_st.init_vit_param``)."""
    from .vit_st import _lecun_, init_vit_param

    for name, p in model.named_parameters():
        if name.startswith("trunk."):
            init_vit_param(name.removeprefix("trunk."), p, generator)
        elif name.endswith("bias"):
            p.zero_()
        elif name.endswith("gamma"):
            p.fill_(1e-6)
        elif name.endswith(("cls_token", "pos_embedding")):
            p.normal_(0.0, 0.02, generator=generator)
        elif p.ndim == 1:  # LayerNorm scale
            p.fill_(1.0)
        else:
            _lecun_(p, generator)


def create_model(ctor=slivit_baseline, device=None, seed: int = 0,
                 state_dict=None, **kw) -> nn.Module:
    """``ctor(**kw)`` on ``device`` (default cuda) in eval mode with seeded
    random weights, then ``state_dict`` imported over them."""
    from ..compat.torch_import import build_model

    return build_model(ctor, init_params, device, seed, state_dict,
                       **kw).eval()

