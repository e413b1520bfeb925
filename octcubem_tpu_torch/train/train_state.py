"""Train state (counterpart of octcubem_tpu/train/train_state.py): the step
count, the params (the module itself), the optimizer, which holds its own
state (count and moments), and the ``torch.Generator`` that draws the
masking noise (JAX's ``rng``).  ``state_dict()`` / ``load_state_dict()``
carry all four across a checkpoint (``core/checkpoint.py``).  A state
sharded over fsdp (``core/fsdp.shard_state``) reads its layout from its
AdamW, ``shards``: its params and moments are then this rank's chunks, and
``load_state_dict`` cuts a checkpoint's whole tensors to them."""

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

    @property
    def shards(self):
        """The fsdp layout (``core/fsdp.FsdpShards``) of a sharded state,
        which its AdamW holds; None for a replicated one."""
        return self.tx.shards

    @classmethod
    def create(cls, params: nn.Module, tx: AdamW, seed: int) -> "TrainState":
        """Step 0, with a generator seeded ``seed`` on the params' device."""
        device = next(params.parameters()).device
        return cls(0, params, tx, torch.Generator(device=device).manual_seed(seed))

    def state_dict(self) -> dict:
        """{"step", "params", "opt_state", "generator"}: references to the
        live tensors; the generator's state is a CPU byte tensor."""
        return {"step": self.step, "params": self.params.state_dict(),
                "opt_state": self.tx.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, state) -> None:
        """Restore a ``state_dict()`` in place: params strictly, the
        optimizer's count and moments, the step and the generator; whole
        tensors cut to this rank's chunks on a sharded state."""
        if self.shards is not None:
            state = self.shards.local_state_dict(state, self.tx)
        self.params.load_state_dict(state["params"], strict=True)
        self.tx.load_state_dict(state["opt_state"])
        self.generator.set_state(state["generator"])
        self.step = int(state["step"])
