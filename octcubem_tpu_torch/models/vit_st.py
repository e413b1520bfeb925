"""Spatiotemporal 3D ViT classifiers (counterpart of
octcubem_tpu/models/vit_st.py), with the reference quirks that
checkpoint-output parity needs:

- flash parity: the final feature is the last block's MLP branch, with
  no final residual add (``parity="flash"``);
- the dropout head with global pool feeds the un-normed pooled feature
  to the head; ``norm``'s parameters are still kept, so reference
  state dicts load strictly.

``quant=True`` is the int8 serving model: the block projections are
``QuantDense`` (load ``ops.quant.quantize_state_dict`` of a float
model's state dict); ``capture_cam=True`` records the activations
``utils.saliency.gradcam`` reads (nn/layers.py).

Parameter names are the reference PyTorch ones (``patch_embed.proj.weight``
[D, C, t, p, p], ``blocks.{i}.mixer.Wqkv.weight`` [out, in], ...).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Dense, LayerNorm, TransformerStack, dropout
from ..nn.patch_embed import PatchEmbed3D
from ..ops.resize import resize_grid_bicubic


class VisionTransformerST(nn.Module):
    """3D tube-patch ViT with separable spatial/temporal pos embeds.
    Input [B, T, H, W, C] channel-last, as in the JAX package."""

    def __init__(self, num_frames: int, t_patch_size: int = 3,
                 img_size: int = 256, patch_size: int = 16,
                 in_chans: int = 1, num_classes: int = 16,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rate: float = 0.0, dropout: float = 0.5,
                 sep_pos_embed: bool = True, cls_embed: bool = True,
                 global_pool: bool = True, head_type: str = "aggregate",
                 high_res_input_size: int | None = None,
                 parity: str = "flash", capture_cam: bool = False,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 remat: bool = False, quant: bool = False):
        super().__init__()
        if head_type not in ("aggregate", "dropout"):
            raise ValueError(f"unknown head_type {head_type!r}")
        self.num_frames, self.t_patch_size = num_frames, t_patch_size
        self.patch_size = patch_size
        self.sep_pos_embed, self.cls_embed = sep_pos_embed, cls_embed
        self.global_pool, self.head_type = global_pool, head_type
        self.dropout = dropout
        # the flax module's field: cli/finetune.py's layer decay reads it
        self.depth = depth

        self.patch_embed = PatchEmbed3D(img_size, patch_size, in_chans,
                                        embed_dim, num_frames, t_patch_size,
                                        dtype=dtype)
        self.high_res_input_size = high_res_input_size
        if high_res_input_size is not None:
            # a second embed for high-res inputs; the pos embeds are then
            # stored at the high-res grid and pooled down for low-res ones
            self.high_res_patch_embed = PatchEmbed3D(
                high_res_input_size, patch_size, in_chans, embed_dim,
                num_frames, t_patch_size, dtype=dtype)
        t_grid = num_frames // t_patch_size
        grid = (img_size if high_res_input_size is None
                else high_res_input_size) // patch_size
        if cls_embed:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        if sep_pos_embed:
            self.pos_embed_spatial = nn.Parameter(
                torch.zeros(1, grid * grid, embed_dim))
            self.pos_embed_temporal = nn.Parameter(
                torch.zeros(1, t_grid, embed_dim))
            if cls_embed:
                self.pos_embed_class = nn.Parameter(
                    torch.zeros(1, 1, embed_dim))
        else:
            n = grid * grid * t_grid + (1 if cls_embed else 0)
            self.pos_embed = nn.Parameter(torch.zeros(1, n, embed_dim))
        self.blocks = TransformerStack(
            depth, embed_dim, num_heads, mlp_ratio, qkv_bias, drop_path_rate,
            dtype=dtype, attn_impl=attn_impl, parity=parity, remat=remat,
            quant=quant, capture_cam=capture_cam)
        self.norm = LayerNorm(embed_dim)
        if head_type == "aggregate":
            self.fc_aggregate_cls = Dense(embed_dim, embed_dim,
                                          compute_dtype=dtype)
            self.aggregate_cls_norm = LayerNorm(embed_dim)
        self.head = Dense(embed_dim, num_classes, compute_dtype=dtype)

    def _pos_embed(self, input_grid: int) -> torch.Tensor:
        if not self.sep_pos_embed:
            return self.pos_embed
        spat = self.pos_embed_spatial
        l = input_grid ** 2
        stored = math.isqrt(spat.shape[1])
        if stored != input_grid:  # bicubic-pool the high-res table
            d = spat.shape[-1]
            spat = resize_grid_bicubic(spat.reshape(1, stored, stored, d),
                                       (input_grid, input_grid)).reshape(1, l, d)
        t_grid = self.num_frames // self.t_patch_size
        # tokens are (t, h, w): the spatial table tiles over t, the
        # temporal one repeats over h*w
        pos = (spat.repeat(1, t_grid, 1)
               + torch.repeat_interleave(self.pos_embed_temporal, l, dim=1))
        if self.cls_embed:
            pos = torch.cat([self.pos_embed_class, pos], dim=1)
        return pos

    def forward_features(self, x, generator: torch.Generator | None = None,
                         return_hidden: bool = False):
        """x: [B, T, H, W, C] -> pooled feature [B, D] (pre-head), or with
        ``return_hidden`` the blocks' list (``TransformerStack``)."""
        input_grid = x.shape[2] // self.patch_size
        pe = (self.high_res_patch_embed
              if self.high_res_input_size is not None
              and x.shape[2] == self.high_res_input_size else self.patch_embed)
        x = pe(x)
        b, t, l, d = x.shape
        x = x.reshape(b, t * l, d)
        if self.cls_embed:
            cls = self.cls_token.to(x.dtype).expand(b, 1, d)
            x = torch.cat([cls, x], dim=1)
        x = x + self._pos_embed(input_grid).to(x.dtype)
        if return_hidden:
            return self.blocks(x, generator, return_hidden=True)
        x = self.blocks(x, generator)
        if self.global_pool:
            start = 1 if self.cls_embed else 0
            pooled = x[:, start:, :].mean(dim=1)
            if self.head_type == "aggregate":
                pooled = self.norm(pooled)
            # dropout head: the reference computes norm(pooled) into an
            # unused variable and heads the raw pooled feature
        elif self.head_type == "aggregate":
            pooled = self.norm(x)[:, 0]
        else:
            pooled = x[:, 0]
        return pooled

    def forward(self, x, generator: torch.Generator | None = None,
                return_embeddings: bool = False, return_hidden: bool = False):
        """x: [B, T, H, W, C] -> logits [B, num_classes] in the compute
        dtype.  ``generator`` draws drop-path and head-dropout masks in
        training mode.  ``return_embeddings`` (dropout head only, as in
        JAX): (logits, the pre-head feature); ``return_hidden``: the
        blocks' list instead of logits."""
        feat = self.forward_features(x, generator, return_hidden)
        if return_hidden:
            return feat
        if self.head_type == "aggregate":
            out = self.aggregate_cls_norm(self.fc_aggregate_cls(feat))
            return self.head(F.gelu(out))
        embedding = feat
        if self.dropout > 0 and self.training:
            feat = dropout(feat, self.dropout, generator)
        out = self.head(feat)
        return (out, embedding) if return_embeddings else out

    def lock_groups(self) -> list[list[str]]:
        """Progressive-unfreeze groups, first to last, as JAX's (the
        reference ``lock()``): the embeddings, each block but the last,
        the last block with the final norm, the head.  Entries are
        state-dict name prefixes."""
        first = ["patch_embed"]
        if self.sep_pos_embed:
            first += ["pos_embed_spatial", "pos_embed_temporal",
                      "pos_embed_class"]
        else:
            first += ["pos_embed"]
        if self.cls_embed:
            first += ["cls_token"]
        groups = [first]
        groups += [[f"blocks.{i}"] for i in range(self.depth - 1)]
        groups += [[f"blocks.{self.depth - 1}", "norm"]]
        if self.head_type == "aggregate":
            groups += [["fc_aggregate_cls", "aggregate_cls_norm", "head"]]
        else:
            groups += [["head"]]
        return groups


# ---- constructor registry (reference models_*.__dict__[name] pattern) ----
# num_heads is overridable (the attention params are [3D, D] / [D, D]
# whatever the head count), and so is depth, to cut a model for a test

def vit_base_patch16(**kw) -> VisionTransformerST:
    kw.setdefault("num_heads", 12)
    kw.setdefault("depth", 12)
    return VisionTransformerST(patch_size=16, embed_dim=768, **kw)


def vit_large_patch16(**kw) -> VisionTransformerST:
    kw.setdefault("num_heads", 16)
    kw.setdefault("depth", 24)
    return VisionTransformerST(patch_size=16, embed_dim=1024, **kw)


flash_attn_vit_large_patch16 = vit_large_patch16


def vit_huge_patch14(**kw) -> VisionTransformerST:
    # 16 heads of head_dim 80: the [B, H, N, D] kernels (B3-B5, B7)
    kw.setdefault("num_heads", 16)
    kw.setdefault("depth", 32)
    return VisionTransformerST(patch_size=14, embed_dim=1280, **kw)


# ---- seeded initialisation (the flax initialisers' distributions) ----

def _trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator):
    """Normal(0, std) truncated to +-2 std, by the inverse CDF."""
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    hi = 0.5 * (1 + math.erf(2 / math.sqrt(2)))
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=g)
    t.erfinv_().mul_(std * math.sqrt(2)).clamp_(-2 * std, 2 * std)


def _lecun_(p: torch.Tensor, g: torch.Generator):
    """flax's lecun_normal: truncated normal, fan_in the elements of one
    output's slice (a Dense kernel's input width, a conv's C * kh * kw)."""
    _trunc_normal_(p, p[0].numel() ** -0.5 / 0.87962566103423978, g)


@torch.no_grad()
def init_vit_param(name: str, p: torch.Tensor, generator: torch.Generator):
    """One ViT parameter with flax's default distribution (``name`` relative
    to the ViT): lecun truncated-normal Dense kernels, xavier-uniform patch
    kernel, N(0, 0.02) head, truncated N(0, 0.02) pos embeds, zero cls
    token and biases, unit LayerNorm scales."""
    if name.endswith("bias") or name == "cls_token":
        p.zero_()
    elif name.endswith("patch_embed.proj.weight"):
        fan_in, fan_out = p[0].numel(), p.shape[0]
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        p.uniform_(-lim, lim, generator=generator)
    elif name == "head.weight":
        p.normal_(0.0, 0.02, generator=generator)
    elif name.startswith("pos_embed"):
        _trunc_normal_(p, 0.02, generator)
    elif p.ndim == 1:  # LayerNorm scale
        p.fill_(1.0)
    else:  # Dense kernel [out, in]
        _lecun_(p, generator)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator):
    """Seeded random weights with flax's default distributions
    (``init_vit_param``); a quant model's int8 weights 0 and scales 1, as
    the JAX QuantDense initialises them."""
    for name, b in model.named_buffers():
        if name.endswith("weight_q"):
            b.zero_()
        elif name.endswith(".scale"):
            b.fill_(1.0)
    for name, p in model.named_parameters():
        init_vit_param(name, p, generator)


def create_model(ctor=vit_large_patch16, device=None, seed: int = 0,
                 state_dict=None, **kw) -> VisionTransformerST:
    """Build ``ctor(**kw)`` on ``device`` (default cuda) in eval mode with
    seeded random weights, then import ``state_dict`` (a reference state
    dict, any layout ``compat.torch_import`` reads) over them: params it
    lacks keep the seeded init, with a warning that names them; keys with
    no slot raise (``compat.torch_import.build_model``)."""
    from ..compat.torch_import import build_model

    return build_model(ctor, init_params, device, seed, state_dict,
                       **kw).eval()
