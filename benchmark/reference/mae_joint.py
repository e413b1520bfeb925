"""The plain reference of the OCTCube joint-resolution MAE pretrainer
(``Pre-training/models_mae_joint_res_flash_attn.py`` under
``engine_pretrain.py``'s ``train_one_epoch_joint``): one step's summed
loss over a batch of 3D volumes and a batch of 2D high-res images, its
gradient, the volumes' per-frame losses (``frame_losses``, which the
self-paced schedule reads) and the blank-region pre-mask, in float32 on
named tensors (``plain.py``), with TF32 off.  The parameters are the 3D
MAE's (``vit3d.mae_specs``): one model, two patch embeds, one decoder.

- 3D branch: the tube patch embed at ``input_size``, the spatial pos
  embed stored at the high-res grid and bicubic-pooled down, plus the
  temporal one; masking at ``mask_ratio`` with the pre-mask's patches
  sorted last; the loss over ``pred_t_dim`` frames.
- 2D branch: an image repeated over one tube of ``t_patch_size`` frames
  at ``high_res_input_size``, the high-res patch embed, the spatial pos
  embed un-pooled and no temporal term; the shared decoder at one tube
  (T = 1); the loss over the tube's own frames.
- The pre-mask (``premask``): 1. each frame's cosine self-similarity of
  the volume's patch embeddings; 2. each patch's mean similarity, the
  top ``p_emb_mask_ratio`` of a frame blank candidates; 3. the top and
  bottom ``up_down_clear`` patch rows cleared; 4. a target count a
  volume, the largest frame count and at least L / 2, each frame topped
  up to it by its highest-scoring other patches, the sorts stable.

Departures from the published description:
- The published pre-mask (``custom_util/misc.py`` ``get_mask`` and
  ``fill_patch_mask_to_ratio``) walks each frame with Python loops over
  connected regions and fills the count column by column; the steps
  above are the vectorised form the program computes: the same count a
  frame and the same most-blank-first order, not the same fill order.
- The published masking derives its visible count from the pre-mask;
  here, as in the program, a sample keeps int(L (1 - mask_ratio))
  tokens, the pre-masked ones sorted last, so every sample of a batch
  keeps as many.
- Float32 throughout, where the published job runs under fp16
  autocast; the plain softmax, as ``plain.py`` says.
"""

from __future__ import annotations

import numpy as np
import torch

from . import plain, vit3d


def premask(p, c: dict, imgs, P: plain.Precision):
    """The blank-region pre-mask of volumes [B, T, H, W, C] from their
    tube patch embeddings -> [B, t*h*w] float, 1 = forced."""
    tp, ps = c["t_patch_size"], c["patch_size"]
    b, t = imgs.shape[0], imgs.shape[1] // tp
    grid = imgs.shape[2] // ps
    l = grid * grid
    feat = P.linear(plain.tube_patches(imgs, tp, ps),
                    plain.tube_kernel(p["patch_embed.proj.weight"]),
                    p["patch_embed.proj.bias"])
    x = feat.reshape(b, t, l, -1)
    x = x / (x.norm(dim=-1, keepdim=True) + 1e-8)
    score = P.matmul(x, x.transpose(-1, -2)).mean(dim=-1)       # [B, T, L]
    k = int(l * c["p_emb_mask_ratio"])
    thresh = torch.sort(score, dim=-1, stable=True).values[..., l - k, None]
    row = torch.arange(l, device=imgs.device) // grid
    clear = c["up_down_clear"]
    border = (row < clear) | (row >= grid - clear)
    cand = ((score >= thresh) & ~border).float()
    target = cand.sum(dim=-1).amax(dim=-1, keepdim=True).clamp(min=l // 2)
    order = torch.argsort(-(cand * 1e6 + score), dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return (rank < target[..., None]).float().reshape(b, t * l)


def branch_terms(p, c: dict, imgs, noise, mask_ratio: float,
                 P: plain.Precision, pre_mask=None, checkpoint: bool = True):
    """One branch of the MAE on a batch -> (per-patch MSE [B, L], mask
    [B, L], 1 = masked).  A 3D volume at ``input_size`` or a 2D image
    (one tube) at ``high_res_input_size``, told apart by its size."""
    tp, ps = c["t_patch_size"], c["patch_size"]
    b, t = imgs.shape[0], imgs.shape[1] // tp
    high = imgs.shape[2] == c["high_res_input_size"]
    grid = imgs.shape[2] // ps
    pe = "high_res_patch_embed" if high else "patch_embed"
    patches = plain.tube_patches(imgs, tp, ps)
    if pre_mask is not None:  # forced patches sort after every other
        noise = noise + (pre_mask > 0).to(noise.dtype)
    ids_keep, ids_restore, mask = vit3d.masking(noise, mask_ratio)

    def pos_of(spatial, temporal):
        if t == 1:  # a 2D image: no temporal term
            return plain.pooled_spatial(spatial, grid)
        return plain.sep_pos(spatial, temporal, grid)

    x = P.linear(vit3d._gather(patches, ids_keep),
                 plain.tube_kernel(p[f"{pe}.proj.weight"]),
                 p[f"{pe}.proj.bias"])
    pos = pos_of(p["pos_embed_spatial"], p["pos_embed_temporal"])
    pos = vit3d._gather(pos.expand(b, -1, -1), ids_keep)
    x = torch.cat([p["cls_token"].expand(b, 1, -1), x], dim=1)
    x = x + torch.cat([p["pos_embed_class"].expand(b, 1, -1), pos], dim=1)
    _, m = plain.stack(p, "blocks.", x, c["depth"], c["num_heads"], P,
                       checkpoint=checkpoint)
    x = plain.layer_norm(m, p["norm.weight"], p["norm.bias"])[:, 1:]

    x = P.linear(x, p["decoder_embed.weight"], p["decoder_embed.bias"])
    n_mask = ids_restore.shape[1] - x.shape[1]
    x = torch.cat([x, p["mask_token"].expand(b, n_mask, -1)], dim=1)
    x = vit3d._gather(x, ids_restore)
    pos = pos_of(p["decoder_pos_embed_spatial"],
                 p["decoder_pos_embed_temporal"])
    x = torch.cat([p["decoder_cls_token"].expand(b, 1, -1), x], dim=1)
    x = x + torch.cat([p["decoder_pos_embed_class"], pos], dim=1)
    _, m = plain.stack(p, "decoder_blocks.", x, c["decoder_depth"],
                       c["decoder_num_heads"], P, checkpoint=checkpoint)
    x = plain.layer_norm(m, p["decoder_norm.weight"], p["decoder_norm.bias"])
    pred = P.linear(x, p["decoder_pred.weight"], p["decoder_pred.bias"])[:, 1:]

    u = tp * c["pred_t_dim"] // c["num_frames"]
    if t == 1:
        target = plain.tube_patches(imgs, u, ps)
    else:
        idx = np.linspace(0, imgs.shape[1] - 1,
                          c["pred_t_dim"]).astype(np.int64)
        target = plain.tube_patches(imgs[:, torch.from_numpy(idx)], u, ps)
    if c.get("norm_pix_loss"):
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, correction=1)
        target = (target - mean) / (var + 1e-6) ** 0.5
    return ((pred - target) ** 2).mean(dim=-1), mask


def _masked_count(length: int, mask_ratio: float) -> int:
    return length - int(length * (1 - mask_ratio))


def joint_loss_and_grads(p, c: dict, vol, noise3d, pre_mask, imgs, noise2d,
                         P: plain.Precision, rows2d=None, block: int = 8):
    """One joint step's loss and gradient -> ({"loss", "loss_3d",
    "loss_2d", "frame_losses" [B, t]}, {name: gradient}).  The volumes go
    one at a time and the 2D images in blocks of ``block``, their
    gradients summed: each loss is a sum over masked patches over the
    batch's count.  ``rows2d``: the 2D images whose loss is taken (all by
    default; a fault reads the mean over a subset)."""
    names = list(p)
    grads = {n: torch.zeros_like(t) for n, t in p.items()}

    def add(part):
        gs = torch.autograd.grad(part, [p[n] for n in names],
                                 allow_unused=True)
        for n, g in zip(names, gs):
            if g is not None:
                grads[n] += g
        return float(part.detach())

    b3, l3 = noise3d.shape
    den3 = b3 * _masked_count(l3, c["mask_ratio"])
    loss3, frames = 0.0, []
    for i in range(b3):
        pp, mask = branch_terms(p, c, vol[i:i + 1], noise3d[i:i + 1],
                                c["mask_ratio"], P, pre_mask[i:i + 1])
        loss3 += add((pp * mask).sum() / den3)
        pl = pp.detach().reshape(1, vol.shape[1] // c["t_patch_size"], -1)
        ml = mask.reshape(pl.shape)
        frames.append((pl * ml).sum(dim=-1) / (ml.sum(dim=-1) + 1e-6))
    rows = list(range(imgs.shape[0]) if rows2d is None else rows2d)
    den2 = len(rows) * _masked_count(noise2d.shape[1], c["mask_ratio_2d"])
    loss2 = 0.0
    for k in range(0, len(rows), block):
        r = torch.tensor(rows[k:k + block], device=imgs.device)
        pp, mask = branch_terms(p, c, imgs[r], noise2d[r],
                                c["mask_ratio_2d"], P)
        loss2 += add((pp * mask).sum() / den2)
    out = {"loss": loss3 + loss2, "loss_3d": loss3, "loss_2d": loss2,
           "frame_losses": torch.cat(frames, dim=0)}
    return out, grads
