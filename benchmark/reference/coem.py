"""The plain reference of the OCTCube-IR two-tower contrastive model
(retinal-COEM's CustomTextCLIP with the OCT ViT-ST tower and the en face
ViT tower) and of its feature-cached accumulation step, in float32 on
named tensors (``plain.py``).

- The OCT tower: the 3D ViT-L/16 trunk, the mean of the last block's MLP
  branch over the tube tokens, LayerNorm, ``fc_aggregate_cls``, its
  LayerNorm, GELU, ``head`` to the embedding width.
- The en face tower: the 2D ViT-L/16 trunk with a learned flat pos
  embedding, ``fc_norm`` over the mean of the last block's MLP branch,
  ``head``, GELU, ``mod_head_0``.
- Both features L2-normalised; the logit scale exp(min(s, ln 100)); the
  symmetric InfoNCE over the batch.
- The LiT lock (OpenCLIP's ``lock``, 9 unlocked groups of D + 2): the
  OCT tower's embeddings and blocks 0 .. D - 9 frozen.
- The accumulation (retinal-COEM's ``train_retclip.py``): every chunk's
  features computed without gradient with the weights before the update;
  then each chunk's loss over the whole bank with that chunk's features
  live, its gradient summed; the logged loss is the chunks' sum over
  accum_freq.  Computed here one pair at a time: the chunk loss's
  gradient with respect to its live features first, then each pair's
  towers differentiated against its share, the frozen prefix of the OCT
  tower taken once per pair from the first pass.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import plain
from .vit3d import block_specs

LOGIT_SCALE_MAX = math.log(100.0)


def specs(cfg: dict) -> list:
    v, e, dim = cfg["vision_cfg"], cfg["enface_cfg"], cfg["embed_dim"]
    d, p, tp = v["embed_dim"], v["patch_size"], v["t_patch_size"]
    g, tg = v["img_size"] // p, v["num_frames"] // tp
    out = [("visual.trunk.patch_embed.proj.weight",
            (d, v["in_chans"], tp, p, p)),
           ("visual.trunk.patch_embed.proj.bias", (d,)),
           ("visual.trunk.cls_token", (1, 1, d)),
           ("visual.trunk.pos_embed_spatial", (1, g * g, d)),
           ("visual.trunk.pos_embed_temporal", (1, tg, d)),
           ("visual.trunk.pos_embed_class", (1, 1, d)),
           ("visual.trunk.norm.weight", (d,)), ("visual.trunk.norm.bias", (d,)),
           ("visual.trunk.fc_aggregate_cls.weight", (d, d)),
           ("visual.trunk.fc_aggregate_cls.bias", (d,)),
           ("visual.trunk.aggregate_cls_norm.weight", (d,)),
           ("visual.trunk.aggregate_cls_norm.bias", (d,)),
           ("visual.trunk.head.weight", (dim, d)),
           ("visual.trunk.head.bias", (dim,))]
    out += block_specs("visual.trunk.blocks", v["depth"], d)
    de, pe = e["embed_dim"], e["patch_size"]
    n = (e["img_size"] // pe) ** 2 + 1
    out += [("enface.trunk.patch_embed.proj.weight",
             (de, e["in_chans"], pe, pe)),
            ("enface.trunk.patch_embed.proj.bias", (de,)),
            ("enface.trunk.cls_token", (1, 1, de)),
            ("enface.trunk.pos_embed", (1, n, de)),
            ("enface.trunk.fc_norm.weight", (de,)),
            ("enface.trunk.fc_norm.bias", (de,)),
            ("enface.head.weight", (dim, de)), ("enface.head.bias", (dim,)),
            ("enface.mod_head_0.weight", (dim, dim)),
            ("enface.mod_head_0.bias", (dim,)),
            ("logit_scale", ())]
    return out + block_specs("enface.trunk.blocks", e["depth"], de)


def trainable(name: str, depth: int, unlocked: int) -> bool:
    """OpenCLIP's ``lock`` on the OCT tower: groups [embeddings, blocks 0
    .. D - 2, the last block with the final norm, the head group], the
    last ``unlocked`` of them train; everything else trains."""
    if not name.startswith("visual."):
        return True
    groups = depth + 2
    if any(t in name for t in ("fc_aggregate_cls", "aggregate_cls_norm",
                               "head")):
        group = groups - 1
    elif ".blocks." in name:
        i = int(name.split(".blocks.")[1].split(".")[0])
        group = i + 1 if i < depth - 1 else depth
    elif ".norm." in name:
        group = depth
    else:
        group = 0
    return group >= groups - unlocked


def first_trainable_block(depth: int, unlocked: int) -> int:
    return next(i for i in range(depth) if trainable(
        f"visual.trunk.blocks.{i}.x", depth, unlocked))


def oct_prefix(p, v: dict, x, upto: int, P):
    """The OCT trunk up to block ``upto`` (frozen) -> its hidden state."""
    tp, ps = v["t_patch_size"], v["patch_size"]
    h = P.linear(plain.tube_patches(x, tp, ps),
                 plain.tube_kernel(p["visual.trunk.patch_embed.proj.weight"]),
                 p["visual.trunk.patch_embed.proj.bias"])
    b = h.shape[0]
    h = torch.cat([p["visual.trunk.cls_token"].expand(b, 1, -1), h], dim=1)
    pos = plain.sep_pos(p["visual.trunk.pos_embed_spatial"],
                        p["visual.trunk.pos_embed_temporal"],
                        x.shape[2] // ps)
    h = h + torch.cat([p["visual.trunk.pos_embed_class"], pos], dim=1)
    h, _ = plain.stack(p, "visual.trunk.blocks.", h, upto, v["num_heads"], P)
    return h


def oct_rest(p, v: dict, h, first: int, P):
    """The OCT trunk from block ``first`` on and its head -> the
    normalised feature."""
    _, m = plain.stack(p, "visual.trunk.blocks.", h, v["depth"],
                       v["num_heads"], P, first=first)
    f = plain.layer_norm(m[:, 1:].mean(dim=1), p["visual.trunk.norm.weight"],
                         p["visual.trunk.norm.bias"])
    f = P.linear(f, p["visual.trunk.fc_aggregate_cls.weight"],
                 p["visual.trunk.fc_aggregate_cls.bias"])
    f = plain.layer_norm(f, p["visual.trunk.aggregate_cls_norm.weight"],
                         p["visual.trunk.aggregate_cls_norm.bias"])
    f = P.linear(F.gelu(f), p["visual.trunk.head.weight"],
                 p["visual.trunk.head.bias"])
    return f / f.norm(dim=-1, keepdim=True)


def enface(p, e: dict, x, P):
    """The en face tower -> the normalised feature."""
    h = P.linear(plain.image_patches(x, e["patch_size"]),
                 plain.image_kernel(p["enface.trunk.patch_embed.proj.weight"]),
                 p["enface.trunk.patch_embed.proj.bias"])
    b = h.shape[0]
    h = torch.cat([p["enface.trunk.cls_token"].expand(b, 1, -1), h], dim=1)
    h = h + p["enface.trunk.pos_embed"]
    _, m = plain.stack(p, "enface.trunk.blocks.", h, e["depth"],
                       e["num_heads"], P)
    f = plain.layer_norm(m[:, 1:].mean(dim=1), p["enface.trunk.fc_norm.weight"],
                         p["enface.trunk.fc_norm.bias"])
    f = F.gelu(P.linear(f, p["enface.head.weight"], p["enface.head.bias"]))
    f = P.linear(f, p["enface.mod_head_0.weight"], p["enface.mod_head_0.bias"])
    return f / f.norm(dim=-1, keepdim=True)


def clip_loss(img, enf, logit_scale):
    scale = torch.clamp(logit_scale, max=LOGIT_SCALE_MAX).exp()
    logits = scale * img @ enf.T
    labels = torch.arange(img.shape[0], device=img.device)
    return (F.cross_entropy(logits, labels)
            + F.cross_entropy(logits.T, labels)) / 2


def accum_loss_and_grads(p, cfg: dict, image, enf_img, P, rows=None,
                         banks=None):
    """One accumulation step's logged loss and summed gradient over the
    trainable leaves (those of ``p`` that require grad).  ``image``
    [A, C, T, H, W, 1], ``enf_img`` [A, C, H, W, 3]; ``rows``: the pairs of
    each chunk that are kept (all by default); ``banks``: a list that
    gets the first pass's features, [OCT, en face], chunks in order."""
    v, e = cfg["vision_cfg"], cfg["enface_cfg"]
    first = first_trainable_block(v["depth"], cfg["lock_unlocked_groups"])
    accum = image.shape[0]
    rows = list(range(image.shape[1])) if rows is None else list(rows)
    pre, img_bank, enf_bank = {}, [], []
    with torch.no_grad():
        for a in range(accum):
            fi, fe = [], []
            for j in rows:
                h = oct_prefix(p, v, image[a, j:j + 1], first, P)
                pre[a, j] = h
                fi.append(oct_rest(p, v, h, first, P))
                fe.append(enface(p, e, enf_img[a, j:j + 1], P))
            img_bank.append(torch.cat(fi))
            enf_bank.append(torch.cat(fe))
    if banks is not None:
        banks += [torch.cat(img_bank), torch.cat(enf_bank)]
    names = [n for n, t in p.items() if t.requires_grad]
    grads = {n: torch.zeros_like(p[n]) for n in names}
    total = 0.0
    for a in range(accum):
        li = img_bank[a].clone().requires_grad_(True)
        le = enf_bank[a].clone().requires_grad_(True)
        imgs = torch.cat(img_bank[:a] + [li] + img_bank[a + 1:])
        enfs = torch.cat(enf_bank[:a] + [le] + enf_bank[a + 1:])
        loss = clip_loss(imgs, enfs, p["logit_scale"])
        gi, ge, gs = torch.autograd.grad(loss, [li, le, p["logit_scale"]])
        grads["logit_scale"] += gs
        total += float(loss.detach())
        for k, j in enumerate(rows):
            fi = oct_rest(p, v, pre[a, j], first, P)
            fe = enface(p, e, enf_img[a, j:j + 1], P)
            part = (fi * gi[k:k + 1]).sum() + (fe * ge[k:k + 1]).sum()
            want = [n for n in names if n != "logit_scale"]
            gs = torch.autograd.grad(part, [p[n] for n in want],
                                     allow_unused=True)
            for n, g in zip(want, gs):
                if g is not None:
                    grads[n] += g
    return total / accum, grads
