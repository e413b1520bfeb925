"""Where the training step's time goes: train_entry()'s ViT-L 3D MAE step
(60x256x256, mask 0.90, bf16, fused AdamW) under torch.profiler, on one
card.

    python -m octcubem_tpu_torch.scripts.profile_step [--dec-heads 16]
        [--iters 3] [--top 20]

Prints the card's name and power limit, the wall time per step (host
clock around steps that end in a synchronize), the device-busy time per
step (the sum of kernel times: one stream, so they do not overlap), the
idle share 1 - busy / wall, the kernel time per step by group (B1, B2,
GEMMs, the optimizer's multi-tensor passes, ...), and the kernels by
device time per step.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from .profile_forward import kernel_rows

# kernel-name substrings -> group, first match wins
GROUPS = (
    ("B1 flash_fwd_packed", ("fwd_bf16_kernel", "fwd_f32_kernel")),
    ("B2 flash_bwd_packed", ("dkdv_bf16_kernel", "dq_bf16_kernel",
                             "dkdv_core_kernel", "dq_core_kernel",
                             "cls_reduce_kernel")),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass", "gemv")),
    ("AdamW and grad norm (multi-tensor)", ("multi_tensor", "foreach")),
    ("LayerNorm", ("layer_norm",)),
    ("GELU", ("gelu", "GeluCUDA")),
    ("reductions", ("reduce_kernel", "Reduce")),
    ("gathers, scatters, sort", ("gather", "scatter", "index", "sort",
                                 "Sort", "radix")),
    ("casts and copies", ("copy", "cast", "Copy")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other elementwise"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dec-heads", type=int, default=16)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--top", type=int, default=20)
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..entry import train_entry

    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    step, state, x = train_entry(dec_heads=args.dec_heads)
    for _ in range(2):
        state, _ = step(state, x, mask_ratio=0.9)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.iters):
        state, _ = step(state, x, mask_ratio=0.9)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iters):
            state, _ = step(state, x, mask_ratio=0.9)
        torch.cuda.synchronize()
    kernels = kernel_rows(prof)
    busy_ms = sum(r[2] for r in kernels) / 1e3 / args.iters
    groups: dict[str, list[float]] = {}
    for key, count, us in kernels:
        g = groups.setdefault(group_of(key), [0.0, 0])
        g[0] += us / 1e3 / args.iters
        g[1] += count // args.iters

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    print(json.dumps({"dec_heads": args.dec_heads, "batch": x.shape[0],
                      "wall_ms_per_step": wall_ms,
                      "device_busy_ms_per_step": busy_ms,
                      "idle_share": 1.0 - busy_ms / wall_ms}))
    for name, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"{ms:9.4f} ms/step  {count:6d}/step  {name}")
    print("--- kernels")
    for key, count, us in kernels[:args.top]:
        print(f"{us / 1e3 / args.iters:9.4f} ms/step  {count // args.iters:6d}/step  "
              f"{key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
