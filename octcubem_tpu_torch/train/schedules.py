"""LR and curriculum schedules (counterpart of octcubem_tpu/train/schedules.py).

Each LR schedule is a function of the optimizer step (an int) returning a
float: the reference MAE per-iteration half-cosine with linear warmup over
fractional epochs (OCTCube/util/lr_sched.py) and the retinal-COEM
per-step cosine with warmup.  Each carries ``total_steps``, the step at
which it ends, which sizes ``optim.AdamW``'s device LR table.
"""

from __future__ import annotations

import math


def warmup_half_cosine(base_lr: float, min_lr: float, warmup_epochs: float,
                       total_epochs: float, steps_per_epoch: int):
    """lr(step) with epoch = step / steps_per_epoch: linear warmup from 0
    to base_lr over warmup_epochs, then min_lr + (base_lr - min_lr) * 0.5
    * (1 + cos(pi * progress))."""

    def schedule(step):
        epoch = step / steps_per_epoch
        if epoch < warmup_epochs:
            return base_lr * epoch / max(warmup_epochs, 1e-8)
        progress = (epoch - warmup_epochs) / max(total_epochs - warmup_epochs,
                                                 1e-8)
        return min_lr + (base_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi
                                                                   * progress))

    schedule.total_steps = math.ceil(total_epochs * steps_per_epoch)
    return schedule


def clip_cosine_lr(base_lr: float, warmup_steps: int, total_steps: int):
    """retinal-COEM cosine_lr: linear warmup by steps, then a plain cosine
    to 0."""

    def schedule(step):
        if step < warmup_steps:
            return base_lr * (step + 1) / max(warmup_steps, 1)
        e = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        return 0.5 * (1 + math.cos(math.pi * e)) * base_lr

    schedule.total_steps = total_steps
    return schedule


def scale_base_lr(blr: float, eff_batch_size: int) -> float:
    """The reference's linear scaling rule: lr = blr * eff_batch / 256."""
    return blr * eff_batch_size / 256.0


def spl_k_schedule(epoch: float, k_max=0.7, k_min=0.3, total_epochs=100,
                   warmup_epochs=10, epoch_offset=0) -> float:
    """Self-paced-learning top-K fraction: K_max during warmup, then a
    linear decay toward K_min."""
    e = epoch - epoch_offset
    if e <= warmup_epochs:
        return k_max
    return k_max - (e - warmup_epochs) * (k_max - k_min) / (
        total_epochs - warmup_epochs - epoch_offset)


def mask_ratio_2d_schedule(epoch: float, ratio_min=0.75, ratio_max=0.85,
                           total_epochs=100, warmup_epochs=10,
                           epoch_offset=0) -> float:
    """The 2D branch's mask-ratio ramp."""
    e = epoch - epoch_offset
    if e <= warmup_epochs:
        return ratio_min
    return ratio_min + (e - warmup_epochs) * (ratio_max - ratio_min) / (
        total_epochs - warmup_epochs - epoch_offset)
