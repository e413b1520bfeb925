"""Device time per call of the flash kernels at their main-path shapes, from
torch.profiler's kernel events (no host time), bf16, laid out as the paths
lay them out:

- the forwards (B1, B3, B5, B6, B8), each beside SDPA's forward device time
  at the same [B, H, N, D] (contiguous), its bound and the host-inclusive
  event time of its wrapper:
  - B1 at the ViT-L forward's (B 1, 4,096 rows + the cls key, H 16, D 64)
    and at the ViT-L MAE step's: encoder (B 4, N 512, H 16, D 64) and
    decoder (B 4, 5,120 rows + the cls key, 16 heads of 32 or 4 of 128),
    on the fused buffer's column views;
  - B3 at the ViT-H/14 classifier's (B 1, 4,096 rows + the cls key, H 16,
    D 80) and B5 at its MAE encoder's (B 4, N 512, H 16, D 80), on the
    [B, H, N, D] views of the fused buffer;
  - B6 at the ViT-L MAE decoder's square shape (B 4, N 5,121, H 16, D 32),
    on the same views;
  - B8's base variant at its harness's shape (BH 64, N 5,121, D 32);
- the backwards: B2 at the ViT-L MAE decoder's, 16 heads of 32 and 4 of
  128, and at its encoder's, on the fused buffer's column views, with
  autograd's [:, 1:] dO after the cls row's concat and the gradient
  written into one dqkv buffer; B4 at the ViT-H/14 classifier's and B7 at
  its MAE encoder's, on the [B, H, N, D] views.

Each call is reported as its total and split by kernel name, so the split
names the body that ran (fwd_hopper_kernel, fwd_bf16_kernel, ...): for a
backward the pass, the dq epilogue, the cls sums, the accumulator's memset
and delta.  A backward also reports a digest of its dk, dv, dkc and dvc
on inputs made from the seed (o and lse from the plain forward), so two
trees' digests say whether they compute bit-identical results.  A kernel of ~40 us timed with CUDA events around its Python
wrapper measures the host as much as the card; the device time measures
the card.

Bounds (``bound``): the larger of a call's tensor-core FLOP at 989 TFLOP/s
dense bf16, its bytes (each input read once, each output written once) at
3.35 TB/s, and, for a forward, its exps (one per score) at the SFU's rate,
16 per clock per SM times the card's SMs times its max SM clock as
nvidia-smi reports it.  The backwards' bounds leave the exp out (one exp
against 10 D FLOP per score).  ``waves`` is a forward's blocks over SMs at
128 query rows per block (the Hopper body's tile).

    python octcubem_tpu_torch/scripts/time_kernels.py [--root DIR] [--iters 100]
        [--rows B1,B3]

``--root`` times the octcubem_tpu_torch package of another tree (e.g. an
unpacked parent commit under build/), so two trees compare in one call;
run the script as a file, not with -m, so that the package imported is
the one under ``--root``.  ``--rows`` keeps the rows whose names start
with one of the given prefixes.  Prints the card's name and power limit,
then one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# MUFU ex2 results per clock per SM on Hopper
EXP_PER_CLOCK_PER_SM = 16


def _smi(query: str) -> str:
    """The first card's answer to ``nvidia-smi --query-gpu=query``."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def exp_rate(torch) -> float:
    """The card's exp rate (ex2 per second): 16 per clock per SM x its SMs
    x its max SM clock."""
    mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return EXP_PER_CLOCK_PER_SM * sms * mhz * 1e6


def bound(flops: float, nbytes: float, exps: float = 0.0,
          rate: float | None = None) -> tuple[float, str]:
    """(the least time in ms, what sets it: "operations", "bytes" or
    "exp") for a call's tensor-core FLOP, bytes and exps."""
    t = {"operations": flops / PEAK_BF16_FLOPS, "bytes": nbytes / PEAK_BYTES,
         "exp": exps / rate if exps else 0.0}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


def fwd_work(b: int, h: int, m: int, keys: int, d: int, es: int = 2):
    """(FLOP, bytes, exps) of a forward over m query rows and ``keys`` keys
    per (batch, head): QK^T and PV, one read of q, k, v and one write of o
    and lse, one exp per score."""
    return (4 * b * h * m * keys * d,
            (2 * b * h * m * d + 2 * b * h * keys * d) * es + b * h * m * 4,
            b * h * m * keys)


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


def event_ms(torch, fn, iters: int) -> float:
    """fn's time per call (ms) with CUDA events around ``iters`` calls after
    2 warm-up calls: the device time plus whatever the host adds."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _fused(torch, gen, b, n, h, d):
    return torch.randn((b, n, 3 * h * d), generator=gen, device="cuda",
                       dtype=torch.bfloat16)


def _bh(qkv, h):
    """The [B, H, N, D] views of a fused [B, N, 3*H*D] buffer."""
    b, n, hd3 = qkv.shape
    return [t.transpose(1, 2) for t in qkv.view(b, n, 3, h, hd3 // (3 * h))
            .unbind(2)]


def forward_row(torch, fn, sdpa_args, work, blocks, rate, iters) -> dict:
    """A forward's device split, event time, SDPA's forward device time at
    the same inputs, bound and waves."""
    import torch.nn.functional as F

    row = device_split(torch, fn, iters)
    row["event_ms"] = event_ms(torch, fn, iters)
    q, k, v, scale = sdpa_args
    row["sdpa_ms"] = device_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, scale=scale), iters)
    row["bound_ms"], row["bound_by"] = bound(*work, rate)
    row["waves"] = blocks / torch.cuda.get_device_properties(0) \
        .multi_processor_count
    return row


def _packed_fwd(torch, fa, gen, b, n, h, d, rate, iters):
    """B1's call on the fused buffer's column views, tokens 1: with the cls
    row folded for a cls-prefixed n."""
    qkv = _fused(torch, gen, b, n, h, d)
    cls = fa._cls_split(n)
    args = fa._split_qkv(qkv, cls)
    scale = d ** -0.5
    m = n - 1 if cls else n
    sdpa = [t.contiguous() for t in _bh(qkv, h)] + [scale]
    return forward_row(torch, lambda: fa.fwd_packed_cuda(*args, h, scale), sdpa,
                       fwd_work(b, h, m, n, d), -(-m // 128) * h * b, rate,
                       iters)


def _bh_fwd(torch, fa, gen, b, n, h, d, rate, iters, no_max=True):
    """B3's (cls-prefixed n), B5's or, with no_max=False, B6's call on the
    [B, H, N, D] views of the fused buffer."""
    qkv = _fused(torch, gen, b, n, h, d)
    q, k, v = _bh(qkv, h)
    cls = no_max and fa._cls_split(n)
    args = ((q[:, :, 1:], k[:, :, 1:], v[:, :, 1:], k[:, :, :1], v[:, :, :1])
            if cls else (q, k, v, None, None))
    scale = d ** -0.5
    m = n - 1 if cls else n
    sdpa = [t.contiguous() for t in (q, k, v)] + [scale]
    return forward_row(torch, lambda: fa.fwd_bh_cuda(*args, scale, None, no_max),
                       sdpa, fwd_work(b, h, m, n, d), -(-m // 128) * h * b,
                       rate, iters)


def _b8_fwd(torch, kablate, gen, rate, iters):
    """B8's base variant at its harness's shape, SDPA on the same inputs as
    [4, BH / 4, N, D]."""
    bh, n, d = kablate.BH, kablate.N, kablate.D
    q, k, v = (torch.randn((bh, n, d), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    sdpa = [t.view(4, bh // 4, n, d) for t in (q, k, v)] + [d ** -0.5]
    return forward_row(torch, lambda: kablate.fwd_variant_cuda(q, k, v), sdpa,
                       fwd_work(1, bh, n, n, d), -(-n // 128) * bh, rate,
                       iters)


def _packed_bwd(torch, fa, gen, b, n, h, d):
    """B2's call as the MAE step makes it: column views of the fused
    buffer, tokens 1: with the cls row folded for a cls-prefixed n; o and
    lse from the plain forward, so that two trees' calls see the same
    inputs."""
    qkv = _fused(torch, gen, b, n, h, d)
    cls = fa._cls_split(n)
    args = fa._split_qkv(qkv, cls)
    scale = d ** -0.5
    o, lse = fa.fwd_packed_plain(*args, h, scale)
    do = torch.randn((b, n, h * d), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    do = do[:, 1:] if cls else do
    out = fa._split_qkv(torch.zeros_like(qkv), cls)
    return lambda: fa.bwd_packed_cuda(*args, o, lse, do, None, h, scale,
                                      out=out)


def _bh_bwd(torch, fa, gen, b, n, h, d):
    """B4's (cls-prefixed n) or B7's call on the [B, H, N, D] views of the
    fused buffer, with autograd's strided dO; o and lse from the plain
    forward."""
    q, k, v = _bh(_fused(torch, gen, b, n, h, d), h)
    cls = fa._cls_split(n)
    args = ((q[:, :, 1:], k[:, :, 1:], v[:, :, 1:], k[:, :, :1], v[:, :, :1])
            if cls else (q, k, v, None, None))
    scale = d ** -0.5
    o, lse = fa.fwd_bh_plain(*args, scale)
    do = torch.randn((b, n, h, d), generator=gen, device="cuda",
                     dtype=torch.bfloat16).transpose(1, 2)
    do = do[:, :, 1:] if cls else do
    return lambda: fa.bwd_bh_cuda(*args, o, lse, do, None, scale)


def digest(torch, ts) -> str:
    """A short sha256 of the bits of tensors ``ts`` (None skipped): equal
    digests from two trees mean bit-identical outputs."""
    h = hashlib.sha256()
    for t in ts:
        if t is not None:
            h.update(t.contiguous().view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[2]))
    parser.add_argument("--iters", type=int, default=100)
    parser.add_argument("--rows", default="",
                        help="comma-separated prefixes of the rows to time "
                             "(e.g. 'B1,B3'); default all")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    from octcubem_tpu_torch.ops import _cuda
    from octcubem_tpu_torch.ops import flash_attention as fa
    from octcubem_tpu_torch.scripts import kablate

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    it = args.iters
    # row -> (its libraries, a function of (gen, rate) -> the row)
    fwd, bwd = ["flash_fwd_packed", "flash_fwd_bh"], ["flash_bwd_packed",
                                                      "flash_bwd_bh"]
    rows = {name: (fwd, lambda g, r, s=shape: _packed_fwd(
        torch, fa, g, *s, r, it)) for name, shape in (
            ("B1 ViT-L serving", (1, 4097, 16, 64)),
            ("B1 MAE encoder", (4, 512, 16, 64)),
            ("B1 MAE decoder h16", (4, 5121, 16, 32)),
            ("B1 MAE decoder h4", (4, 5121, 4, 128)))}
    rows["B3 ViT-H classifier"] = (fwd, lambda g, r: _bh_fwd(
        torch, fa, g, 1, 4097, 16, 80, r, it))
    rows["B5 ViT-H encoder"] = (fwd, lambda g, r: _bh_fwd(
        torch, fa, g, 4, 512, 16, 80, r, it))
    rows["B6 decoder square"] = (fwd, lambda g, r: _bh_fwd(
        torch, fa, g, 4, 5121, 16, 32, r, 20, no_max=False))
    rows["B8 base"] = (["flash_ablate"], lambda g, r: _b8_fwd(
        torch, kablate, g, r, 20))

    def backward(make, shape):
        def row(g, _rate):
            fn = make(torch, fa, g, *shape)
            out = device_split(torch, fn, it)
            # dk, dv, dkc, dvc (dq's fp32 adds arrive in varying order)
            out["digest"] = digest(torch, fn()[1:])
            return out
        return bwd, row

    for name, make, shape in (
            ("B2 decoder h16", _packed_bwd, (4, 5121, 16, 32)),
            ("B2 decoder h4", _packed_bwd, (4, 5121, 4, 128)),
            ("B2 encoder", _packed_bwd, (4, 512, 16, 64)),
            ("B4 ViT-H classifier", _bh_bwd, (1, 4097, 16, 80)),
            ("B7 ViT-H encoder", _bh_bwd, (4, 512, 16, 80))):
        rows[name] = backward(make, shape)
    prefixes = [p for p in args.rows.split(",") if p]
    rows = {name: row for name, row in rows.items()
            if not prefixes or any(name.startswith(p) for p in prefixes)}
    # the libraries these rows need, in parallel, before any timing
    _cuda.build(sorted({lib for libs, _ in rows.values() for lib in libs}))
    gen = torch.Generator(device="cuda").manual_seed(0)
    rate = exp_rate(torch)
    out = {"root": args.root, "exp_per_s": rate}
    for name, (_, row) in rows.items():
        out[name] = row(gen, rate)
        torch.cuda.empty_cache()
    print(_smi("name,power.limit"))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
