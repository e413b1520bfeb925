"""Where the serving forward's time goes: entry()'s bf16 classifier
forward under torch.profiler, on one card: ViT-L/16 at 48x256x256, or
ViT-H/14 (16 heads of 80, kernel B3) at 48x224x224 with ``--model vit-h``.
``--backward`` profiles the fine-tuning pass instead: the forward in
train mode and its backward under a cross-entropy on one label (kernels
B3 and B4 for ViT-H), as chip_smoke.py's phase 6 runs it.

    python -m octcubem_tpu_torch.scripts.profile_forward [--model vit-l]
        [--backward] [--iters 5]

Prints the card's name and power limit, the wall time per forward (host
clock around forwards that end in a synchronize), the device-busy time
per forward (the sum of kernel times: one stream, so they do not
overlap), the idle share 1 - busy / wall, and the kernels by device time
per forward.  ``--trace PATH`` also writes a Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def kernel_rows(prof):
    """(name, count, device us) of the device-side events (kernels and
    copies), by device time.  Host ranges are left out: a custom autograd
    Function's range also carries the time of the kernels it launches;
    so are user ranges (the program's ``octcube.*`` spans), which the
    profiler also projects onto the device's timeline."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU
            and not getattr(e, "is_user_annotation", False)]
    return sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=("vit-l", "vit-h"), default="vit-l")
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--top", type=int, default=15)
    parser.add_argument("--trace", default=None)
    parser.add_argument("--backward", action="store_true")
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..entry import entry
    from ..models import vit_st

    if not torch.cuda.is_available():
        print("profile_forward: no CUDA device", file=sys.stderr)
        return 2
    fn, (model, x) = entry(**(dict(ctor=vit_st.vit_huge_patch14, img_size=224)
                              if args.model == "vit-h" else {}))
    if args.backward:
        import torch.nn.functional as F

        model.train()
        label = torch.tensor([3], device=x.device)
        gen = torch.Generator(device=x.device).manual_seed(8)

        def run():
            model.zero_grad(set_to_none=True)
            F.cross_entropy(model(x, gen).float(), label).backward()
    else:
        def run():
            fn(model, x)
    for _ in range(2):
        run()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.iters):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iters):
            run()
        torch.cuda.synchronize()
    if args.trace:
        prof.export_chrome_trace(args.trace)
    kernels = kernel_rows(prof)
    busy_ms = sum(r[2] for r in kernels) / 1e3 / args.iters

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    what = "fwd_bwd" if args.backward else "forward"
    print(json.dumps({"model": args.model, f"wall_ms_per_{what}": wall_ms,
                      f"device_busy_ms_per_{what}": busy_ms,
                      "idle_share": 1.0 - busy_ms / wall_ms}))
    for key, count, us in kernels[:args.top]:
        print(f"{us / 1e3 / args.iters:9.4f} ms/call  {count // args.iters:5d}/call  "
              f"{key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
