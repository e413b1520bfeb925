"""octcube_ir_vitl16: the OCTCube-IR two-tower contrastive model (an OCT
ViT-L/16 tower over 5,121 tokens, an en face ViT-L/16 tower at 384^2 over
577), trained with the 9-group LiT lock, gradient checkpointing and the
feature-cached accumulation.

The builder of the program's train step (as ``chip_smoke.py``'s phase 20
and ``cli/retclip.py`` build it: the partition lock, AdamW over the
trainable params, ``clip_engine.make_clip_accum_train_step``), with the
benchmark's weights handed in at the program's ``init_params`` seam, and
the analytic FLOP count.
"""

from __future__ import annotations

import copy
import math

from harness import weights, work

FIXED = {"logit_scale": math.log(1 / 0.07)}


def geometry(cfg: dict, overrides: dict | None = None) -> dict:
    """The configuration with ``overrides`` (a cut geometry for the CPU
    tests: ``vision_cfg`` / ``enface_cfg`` entries merged, the rest
    replaced)."""
    g = copy.deepcopy(cfg)
    for k, v in (overrides or {}).items():
        if isinstance(v, dict):
            g[k].update(v)
        else:
            g[k] = v
    return g


def build_clip_train(cfg: dict, device, seed: int, overrides=None):
    """-> (step, state, geometry)."""
    import torch

    from octcubem_tpu_torch.models import coem
    from octcubem_tpu_torch.train import clip_engine, optim, schedules
    from octcubem_tpu_torch.train.train_state import TrainState

    g = geometry(cfg, overrides)
    with weights.injected([coem], seed, FIXED):
        model = coem.create_model(
            coem.COEP2Tower, device=device, seed=0, embed_dim=g["embed_dim"],
            vision_cfg=g["vision_cfg"], enface_cfg=g["enface_cfg"],
            dtype=torch.bfloat16, remat=g["grad_checkpointing"])
    scales = optim.lit_lock_scales(model, g["vision_cfg"]["depth"],
                                   g["lock_unlocked_groups"])
    params = optim.make_partition(model, {k: s > 0 for k, s in scales.items()})
    lr, o = g["optimizer"]["lr"], g["optimizer"]
    sched = schedules.clip_cosine_lr(lr["base"], lr["warmup_steps"],
                                     lr["total_steps"])
    tx = optim.build_adamw(params, sched, o["weight_decay"],
                           betas=tuple(o["betas"]))
    state = TrainState.create(model, tx, seed=1)
    step = clip_engine.make_clip_accum_train_step(model, tx, g["accum_freq"])
    return step, state, g


def flops_per_pair(g: dict) -> float:
    v, e = g["vision_cfg"], g["enface_cfg"]
    oct_tokens = (v["num_frames"] // v["t_patch_size"]) * (
        v["img_size"] // v["patch_size"]) ** 2 + 1
    enf_tokens = (e["img_size"] // e["patch_size"]) ** 2 + 1
    unlocked = g["lock_unlocked_groups"] - 1  # blocks; the head group aside
    return work.coem_flops(
        1, unlocked=unlocked, layers=v["depth"], oct_tokens=oct_tokens,
        oct_pix=v["t_patch_size"] * v["patch_size"] ** 2 * v["in_chans"],
        enf_tokens=enf_tokens,
        enf_pix=e["patch_size"] ** 2 * e["in_chans"], d=v["embed_dim"])
