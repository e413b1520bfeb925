"""The plain reference of the OCTCube ViT-L/16 3D MAE pretrainer: its
loss and gradient, in float32 on named tensors (``plain.py``).

Parameter names are the published PyTorch state dict's, so the
benchmark's weights (``harness/weights.py``, made by name) reach both
sides alike.
"""

from __future__ import annotations

import numpy as np
import torch

from . import plain


def mae_specs(c: dict) -> list:
    """(name, shape) of every MAE parameter for the geometry ``c``."""
    d, dd, p = c["embed_dim"], c["decoder_embed_dim"], c["patch_size"]
    tp, ch = c["t_patch_size"], c["in_chans"]
    tg = c["num_frames"] // tp
    hr = (c["high_res_input_size"] // p) ** 2
    u = tp * c["pred_t_dim"] // c["num_frames"]
    out = []
    for pe in ("patch_embed", "high_res_patch_embed"):
        out += [(f"{pe}.proj.weight", (d, ch, tp, p, p)),
                (f"{pe}.proj.bias", (d,))]
    out += [("cls_token", (1, 1, d)), ("decoder_cls_token", (1, 1, dd)),
            ("pos_embed_class", (1, 1, d)),
            ("decoder_pos_embed_class", (1, 1, dd)),
            ("pos_embed_spatial", (1, hr, d)),
            ("pos_embed_temporal", (1, tg, d)),
            ("decoder_pos_embed_spatial", (1, hr, dd)),
            ("decoder_pos_embed_temporal", (1, tg, dd)),
            ("mask_token", (1, 1, dd)),
            ("norm.weight", (d,)), ("norm.bias", (d,)),
            ("decoder_embed.weight", (dd, d)), ("decoder_embed.bias", (dd,)),
            ("decoder_norm.weight", (dd,)), ("decoder_norm.bias", (dd,)),
            ("decoder_pred.weight", (u * p * p * ch, dd)),
            ("decoder_pred.bias", (u * p * p * ch,))]
    out += block_specs("blocks", c["depth"], d, c.get("mlp_ratio", 4.0))
    out += block_specs("decoder_blocks", c["decoder_depth"], dd,
                       c.get("mlp_ratio", 4.0))
    return out


def block_specs(pre: str, depth: int, d: int, mlp_ratio: float = 4.0):
    h = int(d * mlp_ratio)
    out = []
    for i in range(depth):
        b = f"{pre}.{i}."
        out += [(b + "norm1.weight", (d,)), (b + "norm1.bias", (d,)),
                (b + "mixer.Wqkv.weight", (3 * d, d)),
                (b + "mixer.Wqkv.bias", (3 * d,)),
                (b + "mixer.out_proj.weight", (d, d)),
                (b + "mixer.out_proj.bias", (d,)),
                (b + "norm2.weight", (d,)), (b + "norm2.bias", (d,)),
                (b + "mlp.fc1.weight", (h, d)), (b + "mlp.fc1.bias", (h,)),
                (b + "mlp.fc2.weight", (d, h)), (b + "mlp.fc2.bias", (d,))]
    return out


def masking(noise, mask_ratio: float):
    """The MAE's random masking by a stable argsort of the noise [B, L] ->
    (ids_keep [B, K], ids_restore [B, L], mask [B, L] with 1 = masked),
    K = int(L * (1 - mask_ratio))."""
    b, length = noise.shape
    keep = int(length * (1 - mask_ratio))
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    mask = torch.ones((b, length), device=noise.device)
    mask[:, :keep] = 0.0
    mask = torch.gather(mask, 1, ids_restore)
    return ids_shuffle[:, :keep], ids_restore, mask


def _gather(x, ids):
    return torch.gather(x, 1, ids[..., None].expand(-1, -1, x.shape[-1]))


def mae_sample_terms(p, c: dict, imgs, noise, mask_ratio: float,
                     P: plain.Precision, checkpoint: bool = True):
    """The MAE on a batch -> (sum over masked patches of the per-patch MSE,
    count of masked patches); their ratio over the whole batch is the
    loss, so a batch can be split into samples and their gradients
    summed."""
    tp, ps = c["t_patch_size"], c["patch_size"]
    b, t = imgs.shape[0], imgs.shape[1] // tp
    grid = imgs.shape[2] // ps
    patches = plain.tube_patches(imgs, tp, ps)
    ids_keep, ids_restore, mask = masking(noise, mask_ratio)
    x = P.linear(_gather(patches, ids_keep),
                 plain.tube_kernel(p["patch_embed.proj.weight"]),
                 p["patch_embed.proj.bias"])
    pos = plain.sep_pos(p["pos_embed_spatial"], p["pos_embed_temporal"], grid)
    pos = _gather(pos.expand(b, -1, -1), ids_keep)
    x = torch.cat([p["cls_token"].expand(b, 1, -1), x], dim=1)
    x = x + torch.cat([p["pos_embed_class"].expand(b, 1, -1), pos], dim=1)
    _, m = plain.stack(p, "blocks.", x, c["depth"], c["num_heads"], P,
                       checkpoint=checkpoint)
    x = plain.layer_norm(m, p["norm.weight"], p["norm.bias"])[:, 1:]

    x = P.linear(x, p["decoder_embed.weight"], p["decoder_embed.bias"])
    n_mask = ids_restore.shape[1] - x.shape[1]
    x = torch.cat([x, p["mask_token"].expand(b, n_mask, -1)], dim=1)
    x = _gather(x, ids_restore)
    pos = plain.sep_pos(p["decoder_pos_embed_spatial"],
                        p["decoder_pos_embed_temporal"], grid)
    x = torch.cat([p["decoder_cls_token"].expand(b, 1, -1), x], dim=1)
    x = x + torch.cat([p["decoder_pos_embed_class"], pos], dim=1)
    _, m = plain.stack(p, "decoder_blocks.", x, c["decoder_depth"],
                       c["decoder_num_heads"], P, checkpoint=checkpoint)
    x = plain.layer_norm(m, p["decoder_norm.weight"], p["decoder_norm.bias"])
    pred = P.linear(x, p["decoder_pred.weight"], p["decoder_pred.bias"])[:, 1:]

    u = tp * c["pred_t_dim"] // c["num_frames"]
    idx = np.linspace(0, imgs.shape[1] - 1, c["pred_t_dim"]).astype(np.int64)
    target = plain.tube_patches(imgs[:, torch.from_numpy(idx)], u, ps)
    if c.get("norm_pix_loss"):
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, correction=1)
        target = (target - mean) / (var + 1e-6) ** 0.5
    per_patch = ((pred - target) ** 2).mean(dim=-1)
    return (per_patch * mask).sum(), mask.sum()


def mae_loss_and_grads(p, c: dict, imgs, noise, mask_ratio: float,
                       P: plain.Precision, rows=None):
    """-> (loss, {name: gradient}) of the batch's MAE loss, one sample at
    a time.  ``rows``: the samples whose loss is taken (all by default;
    a fault reads the mean over a subset)."""
    rows = list(range(imgs.shape[0])) if rows is None else list(rows)
    length = noise.shape[1]
    den = len(rows) * max(length - int(length * (1 - mask_ratio)), 1)
    names = list(p)
    grads = {n: torch.zeros_like(t) for n, t in p.items()}
    total = 0.0
    for i in rows:
        num, _ = mae_sample_terms(p, c, imgs[i:i + 1], noise[i:i + 1],
                                  mask_ratio, P)
        part = num / den
        gs = torch.autograd.grad(part, [p[n] for n in names],
                                 allow_unused=True)
        for n, g in zip(names, gs):
            if g is not None:
                grads[n] += g
        total += float(part.detach())
    return total, grads
