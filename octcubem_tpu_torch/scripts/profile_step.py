"""Where the training step's time goes: train_entry()'s 3D MAE step
(mask 0.90, batch 4, bf16, fused AdamW) under torch.profiler, on one card:
ViT-L/16 at 60x256x256, or ViT-H/14 at 60x224x224 with ``--model vit-h``;
with ``--joint``, the vitl_joint_pretrain step (the in-step pre-mask and
the 2D batch of 64 at 3x512x512, in ``--accum-2d`` microbatches, through
a remat model2d with ``--remat-2d``).

    python -m octcubem_tpu_torch.scripts.profile_step [--model vit-l]
        [--dec-heads 16] [--joint [--accum-2d 4] [--remat-2d]]
        [--iters 3] [--top 20]

Prints the card's name and power limit, the wall time per step (host
clock around steps that end in a synchronize; after its first two calls
the step replays its captured CUDA graph, train/step_graph.py), the
device-busy time per step (the sum of kernel times: one stream, so they
do not overlap) of the profiled steps, which run eagerly, and of the
same graph replayed under the profiler (kernel intervals alone: a
replay opens no range), the idle share 1 - busy / wall, the step's
phases from the program's spans (utils/profiling.py: forward, backward,
update and its adamw part, device ms a step, the kernels launched
inside the phase's ``octcube.mae.*`` ranges of the profiled steps; the
timed replays' host ms in ``replay``), the
kernel time per step by group (the flash kernels, GEMMs, the optimizer's
multi-tensor passes, ...), and the kernels by device time per step.
The packed kernels (B1, B2) and the [B, H, N, D] ones (B3-B5, B7) share
their function names; the head_dim template argument tells them apart
on these paths: 80 is ViT-H's encoder (B5, B7), every other head_dim the
packed kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from .profile_forward import kernel_rows

FWD = ("fwd_hopper_kernel", "fwd_bf16_kernel", "fwd_f32_kernel")
BWD = ("bwd_hopper_kernel", "dq_epilogue_kernel", "delta_kernel",
       "dkdv_core_kernel", "dq_core_kernel", "cls_reduce_kernel")
# kernel-name substrings -> group, first match wins
GROUPS = (
    ("flash forward, head_dim 80 (B3 / B5)", tuple(k + "<80" for k in FWD)),
    ("flash backward, head_dim 80 (B4 / B7)", tuple(k + "<80" for k in BWD)),
    ("flash forward, other head_dim (B1)", FWD),
    ("flash backward, other head_dim (B2)", BWD),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass", "gemv")),
    ("AdamW and grad norm (multi-tensor)", ("multi_tensor", "foreach")),
    ("LayerNorm", ("layer_norm",)),
    ("GELU", ("gelu", "GeluCUDA")),
    ("reductions", ("reduce_kernel", "Reduce")),
    ("gathers, scatters, sort", ("gather", "scatter", "index", "sort",
                                 "Sort", "radix")),
    ("casts and copies", ("copy", "cast", "Copy")),
)


MODELS = ("vit-l", "vit-h")


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other elementwise"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=MODELS, default="vit-l")
    parser.add_argument("--dec-heads", type=int, default=16)
    parser.add_argument("--joint", action="store_true")
    parser.add_argument("--accum-2d", type=int, default=4)
    parser.add_argument("--remat-2d", action="store_true")
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--top", type=int, default=20)
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..entry import train_entry
    from ..models import mae3d
    from ..utils import profiling

    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    kw = (dict(ctor=mae3d.mae_vit_huge_patch14, input_size=224)
          if args.model == "vit-h" else {})
    if args.joint:
        kw.update(joint=True, batch2d=64, accum_2d=args.accum_2d,
                  use_premask=True, remat_2d=args.remat_2d)
    step, state, x = train_entry(dec_heads=args.dec_heads, **kw)
    for _ in range(2):
        state, _ = step(state, x, mask_ratio=0.9)
    torch.cuda.synchronize()

    seen = profiling.last_seq()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        state, _ = step(state, x, mask_ratio=0.9)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    host = profiling.phase_medians_ms(profiling.records_since(seen),
                                      profiling.TRAIN_PHASES + (
                                          "premask", "branch2d", "replay"))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iters):
            state, _ = step(state, x, mask_ratio=0.9)
        torch.cuda.synchronize()
    kernels = kernel_rows(prof)
    busy_ms = sum(r[2] for r in kernels) / 1e3 / args.iters
    graph = getattr(step, "func", step).graphs.last
    replay_busy_ms = None
    if graph is not None:
        with profile(activities=[ProfilerActivity.CUDA]) as rprof:
            for _ in range(args.iters):
                graph.graph.replay()
            torch.cuda.synchronize()
        replay_busy_ms = (sum(r[2] for r in kernel_rows(rprof)) / 1e3
                          / args.iters)
    groups: dict[str, list[float]] = {}
    for key, count, us in kernels:
        g = groups.setdefault(group_of(key), [0.0, 0])
        g[0] += us / 1e3 / args.iters
        g[1] += count // args.iters

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    print(json.dumps({"model": args.model, "dec_heads": args.dec_heads,
                      "batch": x.shape[0], "joint": args.joint,
                      "accum_2d": args.accum_2d if args.joint else None,
                      "remat_2d": args.remat_2d,
                      "wall_ms_per_step": wall_ms,
                      "device_busy_ms_per_step": busy_ms,
                      "replay_busy_ms_per_step": replay_busy_ms,
                      "idle_share": 1.0 - busy_ms / wall_ms}))
    device = profiling.range_device_ms(prof)
    print("--- phases (host ms: median of the timed steps; device ms a "
          "profiled step)")
    for ph in dict.fromkeys(list(host) + list(profiling.TRAIN_PHASES)
                            + ["premask", "branch2d"]):
        dev = device.get(f"octcube.mae.{ph}", 0.0) / args.iters
        print(f"{host.get(ph, float('nan')):9.4f} host  {dev:9.4f} device  "
              f"{ph}")
    print("--- kernel groups")
    for name, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"{ms:9.4f} ms/step  {count:6d}/step  {name}")
    print("--- kernels")
    for key, count, us in kernels[:args.top]:
        print(f"{us / 1e3 / args.iters:9.4f} ms/step  {count // args.iters:6d}/step  "
              f"{key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
