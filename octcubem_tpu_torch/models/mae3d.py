"""Joint-resolution 3D masked autoencoder, the OCTCube pretrainer
(counterpart of octcubem_tpu/models/mae3d.py).

Every branch of the JAX module:
- two tube patch embeds, low-res (``input_size``) and high-res
  (``high_res_input_size``); the input's spatial size picks one;
- visible-token-only embedding: patchify, gather the kept rows, embed
  only those (the patch embed is per-token linear, so this equals
  embedding all tokens and discarding the masked ones);
- separable learned pos embeds stored at the high-res grid and bicubic-
  pooled down for low-res inputs each forward (``_spatial_pos``);
- a 2D input (one temporal tube, t == 1) gets no temporal term;
- the decoder appends mask tokens, unshuffles, and infers its temporal
  size from ``ids_restore``;
- the loss: per-patch MSE on the masked tokens over ``pred_t_dim``-
  subsampled frames, optional norm_pix (unbiased variance), and per-frame
  losses for self-paced learning;
- the flash-attn final feature (no last residual add) on both stacks.

The masking noise is an argument (``noise`` [B, L]), drawn by the caller
from a ``torch.Generator``.  ``remat`` / ``remat_norm`` checkpoint each
stack's blocks / LayerNorms (nn/layers.py); ``with_remat`` gives a second
module over the same parameter objects whose stacks rematerialise (the
JAX package's ``model2d``: the same params applied through a remat
graph).  Parameter names are the reference ones, as
``compat.jax_params.state_dict_from_jax`` writes them, so a JAX MAE
loads with ``load_state_dict(strict=True)``; other reference layouts go
through ``compat.torch_import``.  Input [B, T, H, W, C]
channel-last, as in the JAX package.
"""

from __future__ import annotations

import copy
import functools
import math

import numpy as np
import torch
from torch import nn

from ..nn.layers import Dense, LayerNorm, TransformerStack
from ..nn.patch_embed import PatchEmbed3D
from ..ops.masking import gather_tokens, random_masking
from ..ops.patchify import patchify_3d, tube_embed_tokens
from ..ops.resize import resize_grid_bicubic
from .vit_st import _trunc_normal_


@functools.lru_cache(maxsize=16)
def _frame_index(t: int, n: int, device: torch.device) -> torch.Tensor:
    """The loss's ``n`` target frames of ``t``, numpy's float64 linspace
    truncated, as in the JAX package; copied to the device once, so the
    loss does not block the host on a copy each step."""
    idx = np.linspace(0, t - 1, n).astype(np.int64)
    with torch.inference_mode(False):  # usable under autograd later
        return torch.from_numpy(idx).to(device)


class MaskedAutoencoderViT3D(nn.Module):

    def __init__(self, input_size: int = 256, high_res_input_size: int = 512,
                 patch_size: int = 16, in_chans: int = 1,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 decoder_embed_dim: int = 512, decoder_depth: int = 8,
                 decoder_num_heads: int = 16, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, num_frames: int = 60,
                 t_patch_size: int = 3, pred_t_dim: int = 60,
                 sep_pos_embed: bool = True, cls_embed: bool = True,
                 norm_pix_loss: bool = False, drop_path_rate: float = 0.0,
                 parity: str = "flash", dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", remat: bool = False,
                 remat_norm: bool = False):
        super().__init__()
        if not sep_pos_embed:
            raise ValueError("the joint-res MAE needs sep_pos_embed")
        self.input_size, self.high_res_input_size = input_size, high_res_input_size
        self.patch_size, self.in_chans = patch_size, in_chans
        self.embed_dim, self.decoder_embed_dim = embed_dim, decoder_embed_dim
        self.num_frames, self.t_patch_size = num_frames, t_patch_size
        self.pred_t_dim = pred_t_dim
        self.cls_embed, self.norm_pix_loss = cls_embed, norm_pix_loss
        self.dtype = dtype
        d, dd = embed_dim, decoder_embed_dim

        self.patch_embed = PatchEmbed3D(input_size, patch_size, in_chans, d,
                                        num_frames, t_patch_size, dtype=dtype)
        self.high_res_patch_embed = PatchEmbed3D(
            high_res_input_size, patch_size, in_chans, d, num_frames,
            t_patch_size, dtype=dtype)
        hr_l = self.high_res_grid ** 2
        if cls_embed:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
            self.decoder_cls_token = nn.Parameter(torch.zeros(1, 1, dd))
            self.pos_embed_class = nn.Parameter(torch.zeros(1, 1, d))
            self.decoder_pos_embed_class = nn.Parameter(torch.zeros(1, 1, dd))
        self.pos_embed_spatial = nn.Parameter(torch.zeros(1, hr_l, d))
        self.pos_embed_temporal = nn.Parameter(torch.zeros(1, self.t_grid, d))
        self.decoder_pos_embed_spatial = nn.Parameter(torch.zeros(1, hr_l, dd))
        self.decoder_pos_embed_temporal = nn.Parameter(
            torch.zeros(1, self.t_grid, dd))

        self.blocks = TransformerStack(
            depth, d, num_heads, mlp_ratio, qkv_bias, drop_path_rate,
            dtype=dtype, attn_impl=attn_impl, parity=parity, remat=remat,
            remat_norm=remat_norm)
        self.norm = LayerNorm(d)
        self.decoder_embed = Dense(d, dd, compute_dtype=dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dd))
        self.decoder_blocks = TransformerStack(
            decoder_depth, dd, decoder_num_heads, mlp_ratio, qkv_bias,
            drop_path_rate, dtype=dtype, attn_impl=attn_impl, parity=parity,
            remat=remat, remat_norm=remat_norm)
        self.decoder_norm = LayerNorm(dd)
        self.decoder_pred = Dense(
            dd, self.t_pred_patch_size * patch_size ** 2 * in_chans,
            compute_dtype=dtype)

    @property
    def t_pred_patch_size(self) -> int:
        return self.t_patch_size * self.pred_t_dim // self.num_frames

    @property
    def grid(self) -> int:
        return self.input_size // self.patch_size

    @property
    def high_res_grid(self) -> int:
        return self.high_res_input_size // self.patch_size

    @property
    def t_grid(self) -> int:
        return self.num_frames // self.t_patch_size

    def num_tokens(self, imgs: torch.Tensor) -> int:
        """Tube tokens L of an input (the length of its masking noise)."""
        return ((imgs.shape[1] // self.t_patch_size)
                * (imgs.shape[2] // self.patch_size) ** 2)

    def with_remat(self) -> "MaskedAutoencoderViT3D":
        """A module over this one's parameter objects (the same blocks,
        embeds and norms) whose two stacks rematerialise.  Its
        ``parameters()`` are this module's, in the same order."""
        twin = copy.copy(self)
        twin._modules = dict(self._modules)
        for name in ("blocks", "decoder_blocks"):
            stack = copy.copy(getattr(self, name))
            stack._modules = dict(stack._modules)
            stack.remat = True
            twin._modules[name] = stack
        return twin

    # -------------------------------------------------------------- helpers

    def _is_high_res(self, x) -> bool:
        return x.shape[2] == self.high_res_input_size

    def _spatial_pos(self, pos_hr, high_res: bool, d: int):
        """The high-res spatial embedding, bicubic-pooled down for a
        low-res input -> (pos [1, g*g, d], g)."""
        g_hr = self.high_res_grid
        if high_res:
            return pos_hr, g_hr
        grid = pos_hr.reshape(1, g_hr, g_hr, d)
        pooled = resize_grid_bicubic(grid, (self.grid, self.grid))
        return pooled.reshape(1, self.grid * self.grid, d), self.grid

    # ------------------------------------------------------------- encoder

    def encode(self, x, mask_ratio: float, noise=None, pre_mask=None,
               generator: torch.Generator | None = None):
        """x: [B, T, H, W, C] -> (latent, mask, ids_restore).  ``noise``
        [B, L] may be None only when mask_ratio == 0."""
        high_res = self._is_high_res(x)
        pe = self.high_res_patch_embed if high_res else self.patch_embed
        if x.shape[2] != pe.img_size or x.shape[3] != pe.img_size:
            raise ValueError(f"input {x.shape[2]}x{x.shape[3]} != model "
                             f"{pe.img_size}")
        if x.shape[1] % self.t_patch_size:
            raise ValueError(f"{x.shape[1]} frames are not whole tubes of "
                             f"{self.t_patch_size}")
        b = x.shape[0]
        t = x.shape[1] // self.t_patch_size
        l = (x.shape[2] // self.patch_size) ** 2
        d = self.embed_dim
        if noise is None:
            if mask_ratio > 0:
                raise ValueError("masking noise is needed when mask_ratio > 0")
            noise = torch.zeros((b, t * l), device=x.device)

        patches = patchify_3d(x.to(self.dtype), self.t_patch_size,
                              self.patch_size)
        mk = random_masking(noise, t * l, mask_ratio, pre_mask=pre_mask)
        vis = gather_tokens(patches, mk.ids_keep)
        x = tube_embed_tokens(vis, pe.proj.weight, pe.proj.bias)

        pos_spat, g = self._spatial_pos(self.pos_embed_spatial, high_res, d)
        if t == 1:
            pos = pos_spat  # 2D input: no temporal term
        else:
            pos = (pos_spat.repeat(1, t, 1)
                   + torch.repeat_interleave(self.pos_embed_temporal, g * g,
                                             dim=1))
        pos = gather_tokens(pos.expand(b, t * l, d), mk.ids_keep)

        if self.cls_embed:
            cls = self.cls_token.expand(b, 1, d).to(x.dtype)
            x = torch.cat([cls, x], dim=1)
            pos = torch.cat([self.pos_embed_class.expand(b, 1, d), pos], dim=1)
        x = x + pos.to(x.dtype)

        x = self.norm(self.blocks(x, generator))
        if self.cls_embed:
            x = x[:, 1:]
        return x, mk.mask, mk.ids_restore

    # ------------------------------------------------------------- decoder

    def decode(self, x, ids_restore, high_res: bool = False,
               generator: torch.Generator | None = None):
        b = x.shape[0]
        g = self.high_res_grid if high_res else self.grid
        l = g * g
        actual_t = ids_restore.shape[-1] // l

        x = self.decoder_embed(x)
        c = x.shape[-1]
        n_mask = actual_t * l - x.shape[1]
        mask_tokens = self.mask_token.expand(b, n_mask, c).to(x.dtype)
        x = gather_tokens(torch.cat([x, mask_tokens], dim=1), ids_restore)

        pos_spat, _ = self._spatial_pos(self.decoder_pos_embed_spatial,
                                        high_res, c)
        if actual_t == 1:
            pos = pos_spat
        else:
            pos = (pos_spat.repeat(1, self.t_grid, 1)
                   + torch.repeat_interleave(self.decoder_pos_embed_temporal,
                                             l, dim=1))
        if self.cls_embed:
            cls = self.decoder_cls_token.expand(b, 1, c).to(x.dtype)
            x = torch.cat([cls, x], dim=1)
            pos = torch.cat([self.decoder_pos_embed_class, pos], dim=1)
        x = x + pos.to(x.dtype)

        x = self.decoder_pred(self.decoder_norm(
            self.decoder_blocks(x, generator)))
        if self.cls_embed:
            x = x[:, 1:]
        return x

    # --------------------------------------------------------------- loss

    def loss(self, imgs, pred, mask):
        """imgs [B, T, H, W, C]; pred [B, t*h*w, u*p*p*C]; mask [B, L] ->
        (loss, frame_losses [B, t])."""
        t = imgs.shape[1]
        u = self.t_pred_patch_size
        if t == self.t_patch_size:
            target = patchify_3d(imgs, u, self.patch_size)
        else:
            idx = _frame_index(t, self.pred_t_dim, imgs.device)
            target = patchify_3d(imgs[:, idx], u, self.patch_size)
        target = target.float()
        pred = pred.float()
        if self.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, correction=1)
            target = (target - mean) / (var + 1e-6) ** 0.5
        per_patch = ((pred - target) ** 2).mean(dim=-1)  # [B, L]
        mask = mask.reshape(per_patch.shape)

        b = per_patch.shape[0]
        hw = (imgs.shape[2] // self.patch_size) * (imgs.shape[3] // self.patch_size)
        t_tokens = per_patch.shape[1] // hw
        pl = per_patch.reshape(b, t_tokens, -1)
        ml = mask.reshape(b, t_tokens, -1)
        frame_losses = (pl * ml).sum(dim=-1) / (ml.sum(dim=-1) + 1e-6)
        # mask_ratio == 0 has no masked tokens: 0 instead of 0/0
        loss = (per_patch * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss, frame_losses

    # ------------------------------------------------------------- forward

    def forward(self, imgs, mask_ratio: float = 0.75, noise=None,
                pre_mask=None, generator: torch.Generator | None = None):
        """-> (loss, frame_losses, pred, mask).  ``noise`` [B, L] uniform
        draws for the masking; ``generator`` draws drop-path masks in
        training mode."""
        high_res = self._is_high_res(imgs)
        latent, mask, ids_restore = self.encode(imgs, mask_ratio, noise,
                                                pre_mask, generator)
        pred = self.decode(latent, ids_restore, high_res, generator)
        loss, frame_losses = self.loss(imgs, pred, mask)
        return loss, frame_losses, pred, mask

    def forward_patch_embed(self, imgs):
        """Patch embedding only, [B, t*h*w, D] (feeds the blank-region
        pre-mask)."""
        pe = (self.high_res_patch_embed if self._is_high_res(imgs)
              else self.patch_embed)
        x = pe(imgs)
        b, t, l, d = x.shape
        return x.reshape(b, t * l, d)


# ---- constructor registry ----

# num_heads is overridable like decoder_num_heads (the parameters do not
# depend on the head partition), and so is depth, to cut a model for a test

def mae_vit_base_patch16(**kw) -> MaskedAutoencoderViT3D:
    kw.setdefault("num_heads", 12)
    kw.setdefault("depth", 12)
    return MaskedAutoencoderViT3D(patch_size=16, embed_dim=768, **kw)


def mae_vit_large_patch16(**kw) -> MaskedAutoencoderViT3D:
    kw.setdefault("num_heads", 16)
    kw.setdefault("depth", 24)
    return MaskedAutoencoderViT3D(patch_size=16, embed_dim=1024, **kw)


flash_attn_mae_vit_large_patch16 = mae_vit_large_patch16


def mae_vit_huge_patch14(**kw) -> MaskedAutoencoderViT3D:
    # 16 heads of head_dim 80: the encoder runs the [B, H, N, D] kernels
    kw.setdefault("num_heads", 16)
    kw.setdefault("depth", 32)
    return MaskedAutoencoderViT3D(patch_size=14, embed_dim=1280, **kw)


# ---- seeded initialisation (the flax initialisers' distributions) ----

@torch.no_grad()
def init_params(model: MaskedAutoencoderViT3D, generator: torch.Generator):
    """Seeded random weights with the JAX module's distributions: zero
    biases, unit LayerNorm scales, xavier-uniform patch kernels, truncated
    N(0, 0.02) cls tokens and pos embeds, N(0, 0.02) mask token, lecun
    truncated-normal Dense kernels."""
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif name.endswith("patch_embed.proj.weight"):
            fan_in, fan_out = p[0].numel(), p.shape[0]
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            p.uniform_(-lim, lim, generator=generator)
        elif name == "mask_token":
            p.normal_(0.0, 0.02, generator=generator)
        elif "pos_embed" in name or name.endswith("cls_token"):
            _trunc_normal_(p, 0.02, generator)
        elif p.ndim == 1:  # LayerNorm scale
            p.fill_(1.0)
        else:  # Dense kernel [out, in]: lecun normal, truncated at 2 std
            _trunc_normal_(p, p.shape[1] ** -0.5 / 0.87962566103423978,
                           generator)


def create_model(ctor=flash_attn_mae_vit_large_patch16, device=None,
                 seed: int = 0, state_dict=None,
                 **kw) -> MaskedAutoencoderViT3D:
    """Build ``ctor(**kw)`` on ``device`` (default cuda) in training mode
    with seeded random weights, then import ``state_dict`` over them
    (``compat.torch_import.build_model``)."""
    from ..compat.torch_import import build_model

    return build_model(ctor, init_params, device, seed, state_dict,
                       **kw).train()
