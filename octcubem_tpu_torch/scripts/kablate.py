"""Ablation harness for the flash forward at the ViT-L MAE decoder shape
(counterpart of scripts/kablate.py), with kernel B8.

Each variant strips or alters one part of the forward kernel to locate
what bounds it (a stripped variant's results are meaningless as
attention).  B8 (csrc/flash_ablate.cu) replaces the TPU kernel
``scripts/kablate.py::fwd_variant``: B5's fixed-shift forward with the
switches as template flags, on [BH, N, D] bf16 at D = 32, run by the bf16
Hopper forward body (csrc/flash_fwd.cuh, fwd_hopper_kernel) with its
ablation policy.

    python -m octcubem_tpu_torch.scripts.kablate VARIANT [VARIANT...]

  fwd variants (B8 at the base tile): base, noexp, nosum, qkonly,
    mxonly (no exp, no rowsum), mxbf16 (scores rounded to bf16)
  fwd tile variants (B8's base flags; query rows x keys): f128x128 (the
    base's, the Hopper body's own: two consumer warpgroups, 128-key
    tiles), f128x64 (64-key tiles), f64x128 and f64x64 (one consumer
    warpgroup).  Every variant runs at every tile (``fwd_variant_cuda``).
    These are the Hopper body's configurations; the TPU's 512-2048 tiles
    do not carry over, and no tile is left out.
  b* (any name starting with "b"): the port's ``flash_attention`` forward
    and backward at [4, 16, 5121, 32], at the port's own tiles.  5,121 is
    5,120 + cls, so that is B3 + B4 (the launch counts say so); B4 has no
    tile knob, so the tile in the name is not applied (the TPU harness's
    ``BWD_BLOCK_*_TARGET`` knobs are not read by its kernels either).

Times: CUDA events over ``ITERS`` calls after two warm-up calls, one line
per variant.  Needs the card; ``fwd_variant`` runs the plain version on
CPU tensors (the tests).
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from ..ops import _cuda
from ..ops.flash_attention import _for_tma

BH, N, D = 64, 5121, 32
ITERS = 20
SHIFT = 16.0
CLAMP = 40.0

# tile name -> (the C entry's tile index, query rows, keys): the Hopper
# body's configurations, 64 query rows per consumer warpgroup
TILES = {"f128x128": (0, 128, 128), "f128x64": (1, 128, 64),
         "f64x128": (2, 64, 128), "f64x64": (3, 64, 64)}
BASE_TILE = "f128x128"
# variant -> B8's flags (the defaults: exp, rowsum and pv on, fp32 scores)
VARIANTS = {"base": {}, "noexp": dict(exp=False), "nosum": dict(rowsum=False),
            "qkonly": dict(pv=False), "mxonly": dict(exp=False, rowsum=False),
            "mxbf16": dict(s_bf16=True)}


def n_pad_of(n: int, tile: str = BASE_TILE) -> int:
    """n zero-padded to the tile's larger side, as the TPU harness pads."""
    big = max(TILES[tile][1:])
    return (n + big - 1) // big * big


def fwd_variant_plain(q, k, v, n_pad: int, block_k: int, *, exp: bool = True,
                      rowsum: bool = True, pv: bool = True,
                      s_bf16: bool = False):
    """Plain PyTorch B8.  q, k, v: [BH, n, D] -> (o [BH, n, D] in q's
    dtype, lse [BH, n] fp32) over the keys zero-padded to ``n_pad``:
    s = q . k (rounded to bf16 when ``s_bf16``) * D^-0.5; p = exp(min(s,
    40) - 16), or s with ``exp`` off; l = sum p, or 0 with ``rowsum`` off;
    acc = p.astype(v.dtype) v, or with ``pv`` off the sum over key tiles
    of ``block_k`` of each tile's first D columns of p; o = acc / max(l,
    1), or acc with ``rowsum`` off; lse = l.  The pad keys are not masked
    (each adds e^-16 to l), so the result depends on n_pad and block_k."""
    bh, n, d = q.shape
    pad = (0, 0, 0, n_pad - n)
    kp, vp = F.pad(k, pad), F.pad(v, pad)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kp.float())
    if s_bf16:
        s = s.to(torch.bfloat16).float()
    s = s * d ** -0.5
    p = torch.exp(torch.clamp(s, max=CLAMP) - SHIFT) if exp else s
    del s
    l = p.sum(-1) if rowsum else torch.zeros((bh, n), device=q.device)
    if pv:
        acc = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), vp.float())
    else:
        acc = p.view(bh, n, n_pad // block_k, block_k)[..., :d].sum(2)
    if rowsum:
        acc = acc / torch.clamp(l, min=1.0)[..., None]
    return acc.to(q.dtype), l


def _flags(exp=True, rowsum=True, pv=True, s_bf16=False) -> int:
    return int(exp) | 2 * int(rowsum) | 4 * int(pv) | 8 * int(s_bf16)


def fwd_variant_cuda(q, k, v, tile: str = BASE_TILE, **flags):
    """B8 on the card: q, k, v contiguous [BH, n, 32] bf16 CUDA tensors,
    the flags of one of ``VARIANTS`` at any tile of ``TILES``."""
    if q.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, not {q.device}")
    bh, n, d = q.shape
    for t in (q, k, v):
        if (t.shape != (bh, n, D) or t.dtype != torch.bfloat16
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"B8 takes contiguous [BH, n, {D}] bf16 q, k, v "
                             "of one shape and device")
    if _flags(**flags) not in {_flags(**f) for f in VARIANTS.values()}:
        raise ValueError(f"B8 runs the flags of {list(VARIANTS)}, not {flags}")
    q, k, v = (_for_tma(t) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    lib = _cuda.library("flash_ablate")
    with torch.cuda.device(q.device):
        err = lib.octcube_flash_ablate(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, n, n_pad_of(n, tile), d, TILES[tile][0],
            _flags(**flags), float(d ** -0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(lib, err, "flash_ablate")
    _cuda.launches["flash_ablate"] += 1
    return o, lse


def fwd_variant(q, k, v, tile: str = BASE_TILE, **flags):
    """B8 -> (o, lse): the kernel on a CUDA tensor, the plain version (at
    the tile's padding and key tile) on a CPU tensor."""
    if q.device.type == "cuda":
        return fwd_variant_cuda(q, k, v, tile, **flags)
    if q.device.type != "cpu":
        raise ValueError(f"no path for device {q.device}")
    return fwd_variant_plain(q, k, v, n_pad_of(q.shape[1], tile),
                             TILES[tile][2], **flags)


def timeit(name: str, fn, iters: int = ITERS) -> float:
    """ms per call of fn: CUDA events around ``iters`` calls after two
    warm-up calls; prints one line."""
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
    ms = start.elapsed_time(end) / iters
    print(f"{name}: {ms:.4f} ms/iter")
    return ms


def main(argv=None, seed: int = 0) -> dict[str, float]:
    """Time each variant in ``argv`` (default: base) -> {variant: ms}."""
    from ..ops.flash_attention import flash_attention

    variants = list(argv if argv is not None else sys.argv[1:]) or ["base"]
    if not torch.cuda.is_available():
        raise RuntimeError("the ablation harness needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((BH, N, D), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    times = {}
    for name in variants:
        if name in VARIANTS:
            flags = VARIANTS[name]
            label = f"fwd {name} {BASE_TILE} " + (
                " ".join(f"{k}={v}" for k, v in flags.items()) or "(all on)")
            times[name] = timeit(label, lambda: fwd_variant_cuda(
                q, k, v, BASE_TILE, **flags))
        elif name in TILES:
            times[name] = timeit(f"fwd base {name}",
                                 lambda: fwd_variant_cuda(q, k, v, name))
        elif name.startswith("b"):
            q4, k4, v4 = (t.view(4, 16, N, D) for t in (q, k, v))
            q4 = q4.detach().requires_grad_()

            def fwdbwd():
                o = flash_attention(q4, k4, v4)
                return torch.autograd.grad((o.float() ** 2).sum(), q4)[0]

            before = dict(_cuda.launches)
            fwdbwd()
            ran = {c: n - before[c] for c, n in _cuda.launches.items()
                   if n != before[c]}
            times[name] = timeit(
                f"f+b {name} (flash_attention at [4, 16, {N}, {D}], the "
                f"port's tiles, no tile knob; one call launches {ran})",
                fwdbwd)
        else:
            raise ValueError(f"unknown variant {name!r}")
    return times


if __name__ == "__main__":
    main()
