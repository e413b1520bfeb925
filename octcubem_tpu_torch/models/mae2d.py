"""Plain 2D masked autoencoder, RETFound / MAE style (counterpart of
octcubem_tpu/models/mae2d.py): fixed 2D sincos pos embeds, random
masking, per-patch MSE with optional norm_pix (unbiased variance, as
``torch.var``), per-image losses for self-paced learning.

Blocks are the standard ones (``parity="standard"``: the full hidden
state, with its last residual add).  The pos tables are constants, as in
the JAX package: non-persistent buffers, so they are in no state dict
and a reference checkpoint loads strictly.  The masking noise is an
argument (``noise`` [B, L]), drawn by the caller, as in mae3d.  Input
[B, H, W, C] channel-last.  Attention runs B1 / B2 on the packed layout:
for ViT-L/16 at 224 and mask 0.75 the encoder sees 49 kept patches +
cls = 50 tokens (16 heads of 64), the decoder 196 + cls = 197 (16 heads
of 32), neither cls-prefixed in the kernels' sense (n % 128 != 1), so
no cls fold.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..nn.layers import Dense, LayerNorm, TransformerStack
from ..nn.patch_embed import PatchEmbed2D
from ..ops.masking import gather_tokens, random_masking
from ..ops.pos_embed import sincos_2d
from .vit_st import _trunc_normal_


class MaskedAutoencoderViT2D(nn.Module):

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_chans: int = 3, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, decoder_embed_dim: int = 512,
                 decoder_depth: int = 8, decoder_num_heads: int = 16,
                 mlp_ratio: float = 4.0, norm_pix_loss: bool = False,
                 parity: str = "standard", dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", remat: bool = False):
        super().__init__()
        self.img_size, self.patch_size, self.in_chans = (img_size, patch_size,
                                                         in_chans)
        self.embed_dim, self.decoder_embed_dim = embed_dim, decoder_embed_dim
        self.norm_pix_loss = norm_pix_loss
        d, dd = embed_dim, decoder_embed_dim
        self.patch_embed = PatchEmbed2D(img_size, patch_size, in_chans, d,
                                        dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        n = self.grid ** 2 + 1
        self.register_buffer("pos_embed", torch.zeros(1, n, d),
                             persistent=False)
        self.register_buffer("decoder_pos_embed", torch.zeros(1, n, dd),
                             persistent=False)
        self.reset_pos_tables()
        self.blocks = TransformerStack(depth, d, num_heads, mlp_ratio,
                                       dtype=dtype, attn_impl=attn_impl,
                                       parity=parity, remat=remat)
        self.norm = LayerNorm(d)
        self.decoder_embed = Dense(d, dd, compute_dtype=dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dd))
        self.decoder_blocks = TransformerStack(
            decoder_depth, dd, decoder_num_heads, mlp_ratio, dtype=dtype,
            attn_impl=attn_impl, parity=parity, remat=remat)
        self.decoder_norm = LayerNorm(dd)
        self.decoder_pred = Dense(dd, patch_size ** 2 * in_chans,
                                  compute_dtype=dtype)

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @torch.no_grad()
    def reset_pos_tables(self) -> None:
        """(Re)write the fixed sincos tables (the module's constants)."""
        for buf, dim in ((self.pos_embed, self.embed_dim),
                         (self.decoder_pos_embed, self.decoder_embed_dim)):
            buf.copy_(torch.from_numpy(sincos_2d(dim, self.grid, True))[None])

    def patchify(self, imgs):
        """[B, H, W, C] -> [B, L, p*p*C] ((h, w) token order, (p, q, c)
        inner)."""
        b, h, w, c = imgs.shape
        p = self.patch_size
        x = imgs.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, (h // p) * (w // p), p * p * c)

    def unpatchify(self, x):
        b = x.shape[0]
        p, g, c = self.patch_size, self.grid, self.in_chans
        x = x.reshape(b, g, g, p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, g * p, g * p, c)

    def encode(self, x, mask_ratio: float, noise=None):
        """x: [B, H, W, C] -> (latent [B, 1 + K, D] fp32, mask, ids_restore).
        ``noise`` [B, L] may be None only when mask_ratio == 0."""
        x = self.patch_embed(x)
        b, l, d = x.shape
        x = x + self.pos_embed[:, 1:].to(x.dtype)
        if noise is None:
            if mask_ratio > 0:
                raise ValueError("masking noise is needed when mask_ratio > 0")
            noise = torch.zeros((b, l), device=x.device)
        mk = random_masking(noise, l, mask_ratio)
        x = gather_tokens(x, mk.ids_keep)
        cls = (self.cls_token + self.pos_embed[:, :1]).to(x.dtype)
        x = torch.cat([cls.expand(b, 1, d), x], dim=1)
        x = self.norm(self.blocks(x))
        return x, mk.mask, mk.ids_restore

    def decode(self, x, ids_restore):
        x = self.decoder_embed(x)
        b, _, c = x.shape
        l = ids_restore.shape[1]
        mask_tokens = self.mask_token.expand(b, l + 1 - x.shape[1], c)
        x_ = torch.cat([x[:, 1:], mask_tokens.to(x.dtype)], dim=1)
        x_ = gather_tokens(x_, ids_restore)
        x = torch.cat([x[:, :1], x_], dim=1)
        x = x + self.decoder_pos_embed.to(x.dtype)
        x = self.decoder_pred(self.decoder_norm(self.decoder_blocks(x)))
        return x[:, 1:]

    def loss(self, imgs, pred, mask):
        """-> (loss, per_image [B]): per-patch MSE on the masked patches."""
        target = self.patchify(imgs).float()
        pred = pred.float()
        if self.norm_pix_loss:
            mean = target.mean(dim=-1, keepdim=True)
            var = target.var(dim=-1, keepdim=True, correction=1)
            target = (target - mean) / (var + 1e-6) ** 0.5
        per_patch = ((pred - target) ** 2).mean(dim=-1)
        loss = (per_patch * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        per_image = ((per_patch * mask).sum(dim=1)
                     / torch.clamp(mask.sum(dim=1), min=1.0))
        return loss, per_image

    def forward(self, imgs, mask_ratio: float = 0.75, noise=None):
        """-> (loss, per_image, pred, mask)."""
        latent, mask, ids_restore = self.encode(imgs, mask_ratio, noise)
        pred = self.decode(latent, ids_restore)
        loss, per_image = self.loss(imgs, pred, mask)
        return loss, per_image, pred, mask


# depth and decoder_depth are overridable, to cut a model for a test

def mae_vit_base_patch16(**kw) -> MaskedAutoencoderViT2D:
    kw.setdefault("depth", 12)
    kw.setdefault("decoder_depth", 8)
    return MaskedAutoencoderViT2D(patch_size=16, embed_dim=768, num_heads=12,
                                  decoder_embed_dim=512,
                                  decoder_num_heads=16, **kw)


def mae_vit_large_patch16(**kw) -> MaskedAutoencoderViT2D:
    kw.setdefault("depth", 24)
    kw.setdefault("decoder_depth", 8)
    return MaskedAutoencoderViT2D(patch_size=16, embed_dim=1024,
                                  num_heads=16, decoder_embed_dim=512,
                                  decoder_num_heads=16, **kw)


flash_attn_mae_vit_large_patch16 = mae_vit_large_patch16


@torch.no_grad()
def init_params(model: MaskedAutoencoderViT2D, generator: torch.Generator):
    """Seeded random weights with the JAX module's distributions: zero
    biases, unit LayerNorm scales, xavier-uniform patch kernel, truncated
    N(0, 0.02) cls and mask tokens, lecun truncated-normal Dense kernels;
    the sincos tables rewritten."""
    model.reset_pos_tables()
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif name.endswith("patch_embed.proj.weight"):
            fan_in, fan_out = p[0].numel(), p.shape[0]
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            p.uniform_(-lim, lim, generator=generator)
        elif name in ("cls_token", "mask_token"):
            _trunc_normal_(p, 0.02, generator)
        elif p.ndim == 1:  # LayerNorm scale
            p.fill_(1.0)
        else:  # Dense kernel [out, in]: lecun normal, truncated at 2 std
            _trunc_normal_(p, p.shape[1] ** -0.5 / 0.87962566103423978,
                           generator)


def create_model(ctor=mae_vit_large_patch16, device=None, seed: int = 0,
                 state_dict=None, **kw) -> MaskedAutoencoderViT2D:
    """Build ``ctor(**kw)`` on ``device`` (default cuda) in training mode
    with seeded random weights, then import ``state_dict`` over them
    (``compat.torch_import.build_model``)."""
    from ..compat.torch_import import build_model

    return build_model(ctor, init_params, device, seed, state_dict,
                       **kw).train()
