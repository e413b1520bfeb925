"""Device time per call of the flash kernels at their main-path shapes, from
torch.profiler's kernel events (no host time), bf16, laid out as the paths
lay them out:

- B1 at the ViT-L forward's (B 1, 4,096 rows + the cls key, H 16, D 64);
- B5 at the ViT-H/14 MAE encoder's (B 4, N 512, H 16, D 80);
- B2 at the ViT-L MAE decoder's, 16 heads of 32 and 4 of 128 (B 4, 5,120
  rows + the cls key), and at its encoder's (B 4, N 512, H 16, D 64), on
  the fused buffer's column views, with autograd's [:, 1:] dO after the cls
  row's concat and the gradient written into one dqkv buffer;
- B4 at the ViT-H/14 classifier's (B 1, 4,096 rows + the cls key, H 16,
  D 80) and B7 at its MAE encoder's (B 4, N 512, H 16, D 80), on the
  [B, H, N, D] views of the fused buffer.

Each backward call is reported as its total and split by kernel name: the
pass (or passes) of the body, the dq epilogue, the cls sums, the dq
accumulator's memset and the delta einsum.  A kernel of ~40 us timed with
CUDA events around its Python wrapper measures the host as much as the
card; this measures the card.

    python octcubem_tpu_torch/scripts/time_kernels.py [--root DIR] [--iters 100]

``--root`` times the octcubem_tpu_torch package of another tree (e.g. an
unpacked parent commit under build/), so two trees compare in one call;
run the script as a file, not with -m, so that the package imported is
the one under ``--root``.  Prints the card's name and power limit, then
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    if not name.startswith("Memset"):
        name = name.split("(")[0]
    return name[:60]


def device_split(torch, fn, iters: int) -> dict:
    """fn's device time per call (ms), in total and by kernel name, summed
    over the device-side events of ``iters`` calls after 5 warm-up calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU and _device_us(e) > 0:
            key = _short(e.key)
            split[key] = split.get(key, 0.0) + _device_us(e) / 1e3 / iters
    return {"ms": sum(split.values()), "kernels": split}


def device_ms(torch, fn, iters: int) -> float:
    """Mean kernel time per call of fn (ms)."""
    return device_split(torch, fn, iters)["ms"]


def _packed_bwd(torch, fa, gen, b, n, h, d):
    """B2's call as the MAE step makes it: column views of the fused
    buffer, tokens 1: with the cls row folded for a cls-prefixed n."""
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    cls = fa._cls_split(n)
    args = fa._split_qkv(qkv, cls)
    scale = d ** -0.5
    o, lse = fa.fwd_packed_cuda(*args, h, scale)
    do = torch.randn((b, n, h * d), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    do = do[:, 1:] if cls else do
    out = fa._split_qkv(torch.zeros_like(qkv), cls)
    return lambda: fa.bwd_packed_cuda(*args, o, lse, do, None, h, scale,
                                      out=out)


def _bh_bwd(torch, fa, gen, b, n, h, d):
    """B4's (cls-prefixed n) or B7's call on the [B, H, N, D] views of the
    fused buffer, with autograd's strided dO."""
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in qkv.view(b, n, 3, h, d).unbind(2))
    cls = fa._cls_split(n)
    args = ((q[:, :, 1:], k[:, :, 1:], v[:, :, 1:], k[:, :, :1], v[:, :, :1])
            if cls else (q, k, v, None, None))
    scale = d ** -0.5
    o, lse = fa.fwd_bh_cuda(*args, scale)
    do = torch.randn((b, n, h, d), generator=gen, device="cuda",
                     dtype=torch.bfloat16).transpose(1, 2)
    do = do[:, :, 1:] if cls else do
    return lambda: fa.bwd_bh_cuda(*args, o, lse, do, None, scale)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[2]))
    parser.add_argument("--iters", type=int, default=100)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    from octcubem_tpu_torch.ops import _cuda
    from octcubem_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    _cuda.build(["flash_fwd_packed", "flash_fwd_bh", "flash_bwd_packed",
                 "flash_bwd_bh"])  # in parallel, before any timing
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": args.root}
    # B1: the ViT-L forward's fused buffer, tokens 1: with the cls row
    b, n, h, d = 1, 4097, 16, 64
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    args_b1 = fa._split_qkv(qkv, True)
    out["B1_ms"] = device_ms(torch, lambda: fa.fwd_packed_cuda(
        *args_b1, h, d ** -0.5), args.iters)
    # B5: the ViT-H encoder's [B, H, N, D] views of its fused buffer
    b, n, h, d = 4, 512, 16, 80
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in qkv.view(b, n, 3, h, d).unbind(2))
    out["B5_ms"] = device_ms(torch, lambda: fa.fwd_bh_cuda(
        q, k, v, None, None, d ** -0.5), args.iters)
    del qkv, q, k, v
    for name, make, shape in (
            ("B2 decoder h16", _packed_bwd, (4, 5121, 16, 32)),
            ("B2 decoder h4", _packed_bwd, (4, 5121, 4, 128)),
            ("B2 encoder", _packed_bwd, (4, 512, 16, 64)),
            ("B4 ViT-H classifier", _bh_bwd, (1, 4097, 16, 80)),
            ("B7 ViT-H encoder", _bh_bwd, (4, 512, 16, 80))):
        out[name] = device_split(torch, make(torch, fa, gen, *shape),
                                 args.iters)
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
