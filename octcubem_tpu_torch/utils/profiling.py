"""FLOPs / parameter profiling (counterpart of
octcubem_tpu/utils/profiling.py).

Parity target: retinal-COEM/src/training/profile.py (fvcore
FlopCountAnalysis + ActivationCountAnalysis over the model registry, CSV
output).  The JAX package reads XLA's cost analysis of the compiled
program (FLOPs and bytes accessed); the port counts FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` over one eager call.  Torch
has no counterpart of XLA's "bytes accessed" (eager ops are not fused
into one program whose traffic a compiler could add up), so the port
reports none rather than invent a figure.  ``trace`` records a
``torch.profiler`` trace (CPU and, on the card, CUDA activity) as a
Chrome trace.
"""

from __future__ import annotations

import csv
import os
from typing import Callable

import torch


def param_count(params) -> int:
    """Elements over every parameter: a module, or a mapping / iterable
    of tensors or arrays."""
    if isinstance(params, torch.nn.Module):
        leaves = list(params.parameters())
    elif isinstance(params, dict):
        leaves = list(params.values())
    else:
        leaves = list(params)
    n = 0
    for p in leaves:
        size = 1
        for s in p.shape:
            size *= int(s)
        n += size
    return n


def flop_count(fn: Callable, *args) -> dict:
    """FLOPs of one call ``fn(*args)``, counted by ``FlopCounterMode``
    (matmuls, convolutions and attention products; elementwise ops are
    not counted) -> {"flops": total}.  The call runs."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops())}


def vit_flops(n_tokens: int, depth: int, d: int, mlp_ratio: float = 4.0) -> float:
    """Analytic fwd FLOPs of a pre-LN ViT stack (matmul terms)."""
    lin = 2 * n_tokens * (4 + 2 * mlp_ratio) * d * d
    attn = 4 * n_tokens * n_tokens * d
    return depth * (lin + attn)


def profile_models(entries: list[tuple[str, Callable, tuple]],
                   csv_path: str | None = None) -> list[dict]:
    """entries: [(name, fn, example_args)] -> per-model rows with the
    counted GFLOPs; optionally writes a CSV like the reference profiler."""
    rows = []
    for name, fn, args in entries:
        cost = flop_count(fn, *args)
        rows.append({"model": name,
                     "flops_G": round(cost["flops"] / 1e9, 3)})
    if csv_path and rows:
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    return rows


def profiler(log_dir: str):
    """A ``torch.profiler.profile`` of CPU activity, and CUDA activity when
    a card is present, whose trace is written to
    ``log_dir/trace.json`` (Chrome trace format) when it stops."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)

    def write(prof):
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

    return profile(activities=activities, on_trace_ready=write)


def trace(fn: Callable, *args, log_dir: str = "./torch_trace"):
    """Record one ``fn(*args)`` call (synchronized with the card) into
    ``log_dir/trace.json``; returns ``log_dir``."""
    with profiler(log_dir):
        fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return log_dir
