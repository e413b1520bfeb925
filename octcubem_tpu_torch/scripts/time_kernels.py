"""Device time per launch of the fixed-shift forward kernels at their
main-path shapes, from torch.profiler's kernel events (no host time):
B1 at the ViT-L forward's (B 1, 4,096 rows + the cls key, H 16, D 64)
and B5 at the ViT-H/14 MAE encoder's (B 4, N 512, H 16, D 80), bf16, laid
out as the paths lay them out.  A kernel of ~40 us timed with CUDA events
around its Python wrapper measures the host as much as the card; this
measures the card.

    python octcubem_tpu_torch/scripts/time_kernels.py [--root DIR] [--iters 200]

``--root`` times the octcubem_tpu_torch package of another tree (e.g. an
unpacked parent commit under build/), so two trees compare in one call;
run the script as a file, not with -m, so that the package imported is
the one under ``--root``.  Prints the card's name and power limit, then
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_ms(torch, fn, iters: int) -> float:
    """Mean kernel time per call of fn (ms), summed over the device-side
    events of ``iters`` calls after 5 warm-up calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(_device_us(e) for e in prof.key_averages()
             if e.device_type != DeviceType.CPU)
    return us / 1e3 / iters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[2]))
    parser.add_argument("--iters", type=int, default=200)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    from octcubem_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": args.root}
    # B1: the ViT-L forward's fused buffer, tokens 1: with the cls row
    b, n, h, d = 1, 4097, 16, 64
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    hd = h * d
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    args_b1 = (q[:, 1:], k[:, 1:], v[:, 1:], k[:, :1], v[:, :1])
    out["B1_ms"] = device_ms(torch, lambda: fa.fwd_packed_cuda(
        *args_b1, h, d ** -0.5), args.iters)
    # B5: the ViT-H encoder's [B, H, N, D] views of its fused buffer
    b, n, h, d = 4, 512, 16, 80
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in qkv.view(b, n, 3, h, d).unbind(2))
    out["B5_ms"] = device_ms(torch, lambda: fa.fwd_bh_cuda(
        q, k, v, None, None, d ** -0.5), args.iters)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
