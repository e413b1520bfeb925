"""Train state (counterpart of octcubem_tpu/train/train_state.py): the step
count, the params (the module itself), the optimizer, which holds its own
state (count and moments), and the ``torch.Generator`` that draws the
masking noise (JAX's ``rng``)."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .optim import AdamW


@dataclasses.dataclass
class TrainState:
    step: int
    params: nn.Module
    tx: AdamW
    generator: torch.Generator

    @classmethod
    def create(cls, params: nn.Module, tx: AdamW, seed: int) -> "TrainState":
        """Step 0, with a generator seeded ``seed`` on the params' device."""
        device = next(params.parameters()).device
        return cls(0, params, tx, torch.Generator(device=device).manual_seed(seed))
