"""Precision policy: fp32 params, LayerNorms and softmax statistics;
bf16 (or fp32, for the parity path) activations and matmul inputs."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # dtype for softmax / layernorm / loss accumulation
    reduce_dtype: torch.dtype = torch.float32


FP32 = Policy(param_dtype=torch.float32, compute_dtype=torch.float32)
BF16 = Policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)


def policy_from_name(name: str) -> Policy:
    return {"fp32": FP32, "bf16": BF16, "bfloat16": BF16, "float32": FP32}[name]
