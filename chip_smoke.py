#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (octcubem_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase's error is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from csrc/ (nvcc, one process per source);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main paths and their neighbours give it, bf16 and fp32,
     plus a large-logit case, within stated tolerances: B1 (forward) and
     B2 (backward) on the packed layout; B3 / B5 (forward with and
     without the cls fold) and B4 / B7 (their backward) on the
     [B, H, N, D] views of the fused buffer, with the rectangular
     kv_valid form and B7's exact-softmax branch; ragged cases at each
     head_dim of the bf16 one-pass backward (query rows not a multiple
     of its query tile, keys not a multiple of its 128-key tile); every
     backward called twice: dk, dv, dkc, dvc bit-identical, dq (fp32
     adds in varying order) within tolerance on both runs; the bf16
     Hopper forward body (B1, B3, B5 at D in {32, 64, 80, 128}) on both
     routes: ragged rows and keys, with and without the cls fold, the
     rect form with kv_valid < Nk and NaN in the tail rows, q x 40, each
     call made twice with o and lse bit-identical;
  4. the serving path: entry()'s ViT-L 48x256x256 bf16 forward, its
     launch counts, finite [1, 16] logits that agree with the same model
     run with impl="naive";
  5. serving: cli/serve.py's server in a thread with the ViT-L model,
     /healthz and four /predict requests;
  6. the ViT-H/14 classifier (16 heads of 80): entry()'s 48x224x224 bf16
     forward (32 B3 launches, no B1) against impl="naive"; its backward
     under a cross-entropy (32 B3 + 32 B4 launches), and the model cut to
     2 blocks against impl="naive" in loss and per-leaf gradients, fp32
     and bf16;
  7. the training path: train_entry()'s 3D MAE step (mask 0.90, batch 4,
     bf16, AdamW), three steps per configuration: ViT-L/16 at 60x256x256
     with both decoder geometries (32 B1 + 32 B2 launches per step) and
     ViT-H/14 at 60x224x224 (32 B5 + 32 B7 in the encoder, 8 B1 + 8 B2 in
     the decoder); finite loss and grad norm, params unchanged by the
     first update (its LR is 0) and changed by the next two, peak device
     memory, the step's time beside the parent tree's;
  8. flash against impl="naive" under autograd: each MAE cut to 2 + 2
     blocks at batch 2, loss and per-leaf gradients, fp32 and bf16;
  9. B1 and B2 at the ViT-L step's shapes, B3-B5 and B7 at the ViT-H
     paths' shapes, laid out as the paths lay them out, against their
     plain versions (the backward twice, as in phase 3); timings with
     CUDA events (kernel, plain version, a PyTorch library yardstick, the
     bound; the forwards and the steps).  A forward's bound is the larger
     of its products, its bytes and its exps (one per score, at the SFU's
     16 per clock per SM and the card's max SM clock: time_kernels.py);
 10. B6, the exact online softmax, against its plain version, fp32 and
     bf16, D in {32, 64, 80, 128, 256}, square (the fused buffer's
     views, ragged against the tiles) and rect with kv_valid < Nk and NaN
     past it, and with logits far above the fixed shift's clamp (q, k x 8;
     q x 40), where B6 agrees with impl="naive" and B5 does not; each
     case on the body it should run (bf16 at D <= 128 the Hopper body, by
     the kernel's name in a profile) and called twice, bit-identical;
     then B6 + B7's exact branch under autograd against the plain
     versions;
 11. the sequence-parallel layer on a one-rank NCCL group (a FileStore,
     no port): sequence_parallel_attention (no_max True and False) and
     ring_attention against unsharded flash_attention, forward and
     gradients, at the ViT-L MAE decoder's [4, 16, 5121, 32] in bf16;
     then that decoder's TransformerStack(8, 512, 16) at full width, batch
     4, bf16, with attn_impl="flash_sp" against attn_impl="flash" from the
     same weights: loss and per-leaf gradients, 8 B5 + 8 B7 launches
     against 8 B1 + 8 B2;
 12. the 4-shard geometry on one card: each rank's local body of
     sequence_parallel_attention (1,281 query rows of the decoder's 5,121
     padded to 5,124, against all 5,124 keys with kv_valid 5,121), B5 and
     B6, against unsharded attention; the shards' gradients summed
     against the unsharded ones, pad rows' gradients exactly 0;
 13. B8 on the Hopper body, every ablation variant at every tile,
     against its plain version at the harness's shape (BH 64, N 5,121,
     D 32), then the harness's timings (scripts/kablate.py);
 14. timings of B6 (the decoder's square shape and the shard shape,
     beside the parent's mma.sync body's) and B8 against their bounds,
     plain versions and SDPA, then one {"kernels": [...]} line with
     B1-B8.
The last line is {"ok": true, "device": {...}}.  Exits non-zero with no
result when there is no CUDA device or no port package beside it.
"""

from __future__ import annotations

import io
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# kernel-vs-plain tolerances: |d| <= atol + rtol * |plain|.
# fp32: the JAX kernel tests' own 5e-5 (summation order only).
# bf16: o is rounded to bf16 on both sides, so one rounding step apart is
# 2^-7 relative; allow two, plus an absolute floor for values near 0.
TOL_O = {"float32": (5e-5, 0.0), "bfloat16": (2 ** -8, 2 ** -6)}
TOL_LSE = 1e-4  # fp32 statistics on both sides
# B2 kernel-vs-plain, |d| <= tol * max|plain| per output:
# fp32: the JAX kernel-gradient tolerance (tests/test_flash_attention.py);
# the sums run over up to 5,121 terms in another order.
# bf16: each output is rounded to bf16 on both sides (2^-9 relative), and
# p and ds are rounded to bf16 before their products on both sides, so a
# score whose fp32 value differs in the last bit may round the other way;
# allow one bf16 step of the largest gradient, 2^-8, twice over.
# The bf16 backward at head_dim <= 128 adds dq's per-key-tile shares in
# fp32 in varying order: dq is held to the same tolerance on each of two
# runs, dk, dv, dkc and dvc must be bit-identical between them.
TOL_GRAD = {"float32": 5e-4, "bfloat16": 2 ** -7}

# the ViT-L and ViT-H step times of the parent tree: this script's own
# phase 7 in PR 4's final run, NVIDIA H100 80GB HBM3 at 700 W (PERF.md)
PARENT_STEP_MS = {("ViT-L/16 60x256x256", 16): 118.597,
                  ("ViT-L/16 60x256x256", 4): 105.866,
                  ("ViT-H/14 60x224x224", 16): 151.139}
# B6 on the body it ran before the Hopper one (the mma.sync kernel), CUDA
# events per call at phase 14's two shapes, NVIDIA H100 80GB HBM3 at
# 700 W: the mean of scripts/time_kernels.py's two parent runs in an A/B
# call (PERF.md)
PARENT_B6_MS = {"square": 1.24775, "shard": 0.38244}
# the ViT-L logits, flash (fixed shift, unnormalised bf16 p) vs naive
# (exact softmax, normalised bf16 p) through 24 bf16 blocks.  Measured on an
# H100 at 700 W with seeded weights: 7.8e-3 (first kernel version) and
# 5.9e-3 (this one), on logits up to 0.92; the limit is ~2.5x the larger.
TOL_LOGITS = 2e-2


def _elapsed_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
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


def _kernel_args(qkv, num_heads):
    """B1's inputs for a fused buffer: tokens 1: with the cls row folded
    for a cls-prefixed n, else all tokens."""
    hd = qkv.shape[-1] // 3
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    n = qkv.shape[1]
    if n % 128 == 1 and n > 128:
        return q[:, 1:], k[:, 1:], v[:, 1:], k[:, :1], v[:, :1]
    return q, k, v, None, None


def check_flash_fwd(torch, fa):
    """Phase 3: B1 against its plain version.  Returns the max |do| at the
    ViT-L shape in bf16."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(4097, 16, 64, 1.0), (4097, 8, 128, 1.0), (1025, 32, 32, 1.0),
             (513, 4, 256, 1.0), (4000, 16, 64, 1.0),
             (512, 16, 64, 1.0),  # the MAE encoder's: 511 + cls, no fold
             (4097, 16, 64, 40.0)]  # q scaled: most logits above the clamp
    vitl_err = None
    for n, h, d, qmul in cases:
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((1, n, 3 * h * d), generator=gen, device="cuda")
            qkv[..., :h * d] *= qmul
            qkv = qkv.to(dtype)
            args = _kernel_args(qkv, h)
            scale = d ** -0.5
            o, lse = fa.fwd_packed_cuda(*args, h, scale)
            torch.cuda.synchronize()
            o_ref, lse_ref = fa.fwd_packed_plain(*args, h, scale)
            do = (o.float() - o_ref.float()).abs()
            atol, rtol = TOL_O[str(dtype).split(".")[1]]
            excess = (do - rtol * o_ref.float().abs()).max().item()
            dlse = (lse - lse_ref).abs().max().item()
            clamped = "" if qmul == 1.0 else " large-logit"
            print(f"B1 n={n} H={h} D={d} {str(dtype)[6:]}{clamped} "
                  f"cls={args[3] is not None}: max|do|={do.max().item():.3e} "
                  f"(tol {atol:.1e}+{rtol:.1e}|o|) max|dlse|={dlse:.3e} "
                  f"(tol {TOL_LSE:.0e})")
            if not (excess <= atol and dlse <= TOL_LSE
                    and torch.isfinite(o.float()).all()):
                raise AssertionError(f"B1 disagrees with its plain version "
                                     f"at n={n} H={h} D={d} {dtype}")
            if (n, h, d, qmul, dtype) == (4097, 16, 64, 1.0, torch.bfloat16):
                vitl_err = do.max().item()
    return vitl_err


def check_hopper_fwd(torch, fa):
    """Phase 3, the bf16 Hopper forward body (B1 on the packed route, B3 /
    B5 on the [B, H, N, D] views) at each D it serves against its plain
    version: 1,000 query rows and keys (no multiple of the 128-row and
    128-key tiles) without the cls fold, 1,000 + cls with it, q x 40 with
    it (most logits above the clamp), and B5's rect form (333 query rows,
    700 keys, kv_valid 651, NaN in k and v past it).  Each call is made
    twice: o and lse must be bit-identical (the forward has no atomics)."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    dtype = torch.bfloat16
    atol, rtol = TOL_O["bfloat16"]
    for d in (32, 64, 80, 128):
        h, scale = 4, d ** -0.5
        for case in ("ragged", "cls", "large-logit cls", "rect"):
            routes = ["bh"] + (["packed"] if d in fa.HEAD_DIMS
                               and case != "rect" else [])
            for route in routes:
                kv = None
                if case == "rect":
                    q = torch.randn((2, h, 333, d), generator=gen,
                                    device="cuda").to(dtype)
                    k, v = (torch.randn((2, h, 700, d), generator=gen,
                                        device="cuda").to(dtype)
                            for _ in range(2))
                    kv = 651
                    k[:, :, kv:], v[:, :, kv:] = math.nan, math.nan
                    args = (q, k, v, None, None)
                else:
                    cls = case != "ragged"
                    qkv = torch.randn((2, 1000 + cls, 3 * h * d),
                                      generator=gen, device="cuda")
                    if case.startswith("large"):
                        qkv[..., :h * d] *= 40.0
                    qkv = qkv.to(dtype)
                    args = (fa._split_qkv(qkv, cls) if route == "packed"
                            else _bh_args(qkv, h, cls))
                if route == "packed":
                    def call():
                        return fa.fwd_packed_cuda(*args, h, scale)
                    o_ref, lse_ref = fa.fwd_packed_plain(*args, h, scale)
                else:
                    def call():
                        return fa.fwd_bh_cuda(*args, scale, kv)
                    o_ref, lse_ref = fa.fwd_bh_plain(*args, scale, kv)
                (o, lse), (o2, lse2) = call(), call()
                torch.cuda.synchronize()
                d_o = (o.float() - o_ref.float()).abs()
                excess = (d_o - rtol * o_ref.float().abs()).max().item()
                dlse = (lse - lse_ref).abs().max().item()
                same = torch.equal(o, o2) and torch.equal(lse, lse2)
                print(f"Hopper forward {route} D={d} {case}: max|do|="
                      f"{d_o.max().item():.3e} (tol {atol:.1e}+{rtol:.1e}|o|) "
                      f"max|dlse|={dlse:.3e} (tol {TOL_LSE:.0e}); two runs "
                      f"bit-identical: {same}")
                if not (excess <= atol and dlse <= TOL_LSE and same
                        and torch.isfinite(o.float()).all()):
                    raise AssertionError(f"the Hopper forward disagrees with "
                                         f"its plain version or with itself: "
                                         f"{route} D={d} {case}")
                del args, o, lse, o2, lse2, o_ref, lse_ref


def _grads_twice(torch, what, call, ref, dtype):
    """A backward ``call`` made twice on the same inputs against its plain
    version ``ref`` (dq, dk, dv, dkc, dvc): each output of each run within
    TOL_GRAD x max|plain| and finite; dk, dv, dkc, dvc bit-identical
    between the runs.  Prints the largest run-to-run |d dq|.  Returns
    ({output: max |d|}, the outputs) of the first run."""
    first = call()
    second = call()
    torch.cuda.synchronize()
    tol = TOL_GRAD[str(dtype).split(".")[1]]
    errs, ok = {}, True
    for name, a, b, r in zip(("dq", "dk", "dv", "dkc", "dvc"), first, second,
                             ref):
        if r is None:
            ok &= a is None and b is None
            continue
        top = r.float().abs().max().item()
        errs[name] = (a.float() - r.float()).abs().max().item()
        for got in (a, b):
            ok &= ((got.float() - r.float()).abs().max().item() <= tol * top
                   and bool(torch.isfinite(got.float()).all()))
        if name != "dq":
            ok &= torch.equal(a, b)
    rerun = (first[0].float() - second[0].float()).abs().max().item()
    print(f"{what}: max|d| " + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + f" (tol {tol:.1e} x max|plain|); run to run max|d dq|="
          f"{rerun:.3e}, dk dv dkc dvc identical")
    if not ok:
        raise AssertionError(f"{what}: the backward disagrees with its plain "
                             "version, or dk / dv / dkc / dvc moved between "
                             "two runs")
    return errs, first


def check_flash_bwd(torch, fa):
    """Phase 3, B2: against its plain version at B=1 on B1's own (o, lse),
    with a random dO and g_lse.  (Phase 8 holds it at B=4, as the training
    step lays it out.)"""
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(5121, 16, 32, 1.0), (5121, 4, 128, 1.0),  # the decoder's
             (512, 16, 64, 1.0),  # the encoder's: 511 + cls, no fold
             (4000, 16, 64, 1.0), (1025, 8, 128, 1.0), (513, 4, 256, 1.0),
             (1025, 8, 128, 40.0),  # q scaled: most logits above the clamp
             # ragged: rows and keys not multiples of the one pass's tiles
             (700, 8, 32, 1.0), (333, 4, 64, 1.0), (901, 2, 128, 1.0)]
    for n, h, d, qmul in cases:
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((1, n, 3 * h * d), generator=gen, device="cuda")
            qkv[..., :h * d] *= qmul
            qkv = qkv.to(dtype)
            args = _kernel_args(qkv, h)
            scale = d ** -0.5
            o, lse = fa.fwd_packed_cuda(*args, h, scale)
            do = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
            g_lse = 0.1 * torch.randn(lse.shape, generator=gen, device="cuda")
            ref = fa.bwd_packed_plain(*args, o, lse, do, g_lse, h, scale)
            clamped = "" if qmul == 1.0 else " large-logit"
            _grads_twice(torch, f"B2 n={n} H={h} D={d} {str(dtype)[6:]}"
                         f"{clamped} cls={args[3] is not None}",
                         lambda: fa.bwd_packed_cuda(*args, o, lse, do, g_lse,
                                                    h, scale), ref, dtype)
            del qkv, o, lse, do, ref


def _nonzero(launches):
    return {k: c for k, c in launches.items() if c}


def run_main_path(torch, _cuda, entry_mod, name="ViT-L 48x256x256",
                  counter="flash_fwd_packed", **entry_kw):
    """Phases 4 and 6: entry()'s forward through the kernels: one launch
    of ``counter`` per block and no other kernel."""
    fn, (model, x) = entry_mod.entry(**entry_kw)
    _cuda.reset_launches()
    logits = fn(model, x)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    print(f"entry forward {name}: logits {list(logits.shape)} {logits.dtype}, "
          f"launches {_nonzero(launches)}")
    if tuple(logits.shape) != (1, 16) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits {logits}")
    depth = len(model.blocks)
    if _nonzero(launches) != {counter: depth}:
        raise AssertionError(f"expected {depth} {counter} launches and no "
                             f"other kernel, got {launches}")

    mhas = [m for m in model.modules() if hasattr(m, "attn_impl")]
    for m in mhas:
        m.attn_impl = "naive"
    ref = fn(model, x)
    for m in mhas:
        m.attn_impl = "auto"
    err = (logits.float() - ref.float()).abs().max().item()
    print(f"entry forward {name} vs impl='naive': max|dlogits|={err:.3e} "
          f"(tol {TOL_LOGITS:.0e}; max|logits|="
          f"{ref.float().abs().max().item():.3e})")
    if err > TOL_LOGITS:
        raise AssertionError(f"flash and naive {name} forwards disagree")
    return fn, model, x, depth


def _post_npy(url, arr):
    buf = io.BytesIO()
    import numpy as np
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read().decode())


def run_serve(torch, _cuda, serve):
    """Phase 5: the server answers healthz and four predicts."""
    import numpy as np

    started, box, errors = threading.Event(), [], []

    def run():
        try:
            serve.main(["--port", "0", "--seed", "0"], started, box)
        except BaseException as e:  # reported by the main thread
            errors.append(e)
            started.set()

    _cuda.reset_launches()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    if not started.wait(timeout=600):
        raise AssertionError("server did not start")
    if errors:
        raise errors[0]
    httpd = box[0]
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read().decode())
        print(f"serve /healthz: {r.status} {health}")
        rng = np.random.default_rng(0)
        vols = [("?raw=0", rng.random((48, 256, 256), dtype=np.float32))
                for _ in range(3)]
        vols.append(("", (rng.random((40, 200, 300)) * 255).astype(np.float32)))
        for query, vol in vols:
            code, out = _post_npy(base + "/predict" + query, vol)
            probs = np.asarray(out.get("probs", [[np.nan]]), np.float64)
            print(f"serve /predict{query} {list(vol.shape)}: {code} "
                  f"probs {probs.shape} latency_ms {out.get('latency_ms')}")
            if code != 200 or probs.shape != (1, 8) or not np.isfinite(probs).all():
                raise AssertionError(f"bad predict answer {code} {out}")
    finally:
        httpd.shutdown()
        th.join(timeout=60)
    launches = dict(_cuda.launches)
    print(f"serve launches (warm-up + 4 predicts): {launches}")
    if launches["flash_fwd_packed"] != 24 * 5:
        raise AssertionError(f"expected {24 * 5} B1 launches, got {launches}")


def time_flash_fwd(torch, fa, rate):
    """Phase 9: B1 at the ViT-L shape: kernel, plain version, the library
    yardstick and the bound (``rate``: the card's exps per second)."""
    import torch.nn.functional as F

    from octcubem_tpu_torch.scripts.time_kernels import bound, fwd_work

    b, n, h, d = 1, 4097, 16, 64
    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    args = _kernel_args(qkv, h)
    scale = d ** -0.5
    ms = _elapsed_ms(lambda: fa.fwd_packed_cuda(*args, h, scale), 50)
    plain_ms = _elapsed_ms(lambda: fa.fwd_packed_plain(*args, h, scale), 5, 1)
    qh, kh, vh = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
    library_ms = _elapsed_ms(
        lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 50)
    m = n - 1  # query rows of the kernel; keys are m plus the cls
    flops, nbytes, exps = fwd_work(b, h, m, n, d)
    bound_ms, bound_by = bound(flops, nbytes, exps, rate)
    print(f"B1 timing at B={b} H={h} N={n} D={d} bf16: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms by {bound_by} ({flops:.3e} FLOP, "
          f"{nbytes:.3e} B, {exps:.3e} exp at {rate:.3e}/s); "
          f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def mae_train_flops(d=1024, layers=24, dd=512, dlayers=8, frames=60,
                    img=256, patch=16, tpatch=3, mask=0.90) -> float:
    """Analytic FLOPs of one ViT-L 3D MAE train step per volume (fwd + bwd
    = 3 x fwd): the port's copy of bench.py's mae_train_flops, which this
    script may not import (bench.py imports JAX)."""
    l_full = (frames // tpatch) * (img // patch) ** 2     # 5120
    l_vis = int(l_full * (1 - mask)) + 1                  # 511 + cls
    l_dec = l_full + 1
    dense = (layers * 2 * l_vis * 12 * d * d + dlayers * 2 * l_dec * 12 * dd * dd
             + 2 * l_full * (tpatch * patch * patch) * d
             + 2 * l_dec * dd * (tpatch * patch * patch)
             + 2 * l_dec * d * dd)
    attn = layers * 4 * l_vis * l_vis * d + dlayers * 4 * l_dec * l_dec * dd
    return 3.0 * (dense + attn)


def run_train(torch, _cuda, entry_mod, optim, name, geometries, expect,
              flops_kw, **entry_kw):
    """Phase 7: three MAE steps per decoder geometry, with their launch
    counts (``expect``, and no other kernel), the LR-0 first update and
    peak memory; then the step's time.  Returns the last step's
    launches."""
    last = None
    for dec_heads in geometries:
        torch.cuda.reset_peak_memory_stats()
        step, state, x = entry_mod.train_entry(dec_heads=dec_heads, batch=4,
                                               **entry_kw)
        model, tx = state.params, state.tx
        names = [n for n, _ in model.named_parameters()]
        before = [p.detach().clone() for p in model.parameters()]
        if tx.lr(0) != 0.0:
            raise AssertionError(f"the schedule's first LR is {tx.lr(0)}")
        for i in range(3):
            _cuda.reset_launches()
            state, m = step(state, x, mask_ratio=0.9)
            torch.cuda.synchronize()
            last = dict(_cuda.launches)
            loss, gn = m["loss"].item(), m["grad_norm"].item()
            print(f"train {name} dec_heads={dec_heads} step {i + 1}: loss "
                  f"{loss:.6f} grad_norm {gn:.6f} lr {tx.lr(i):.4e} launches "
                  f"{_nonzero(last)}")
            if not (math.isfinite(loss) and math.isfinite(gn)):
                raise AssertionError("non-finite loss or grad norm")
            if _nonzero(last) != expect:
                raise AssertionError(f"expected launches {expect} per step "
                                     f"and no other kernel, got {last}")
            if i == 0 and not all(torch.equal(a, p) for a, p in
                                  zip(before, model.parameters())):
                raise AssertionError("params moved at the first update, "
                                     "whose LR is 0")
        decayed = optim.weight_decay_mask(model)
        # the only params allowed to stay put: no gradient, no decay
        free = {n for n, p in model.named_parameters()
                if p.grad is None and not decayed[n]}
        still = {n for n, a, p in zip(names, before, model.parameters())
                 if torch.equal(a, p)}
        print(f"train {name} dec_heads={dec_heads}: {len(names) - len(still)} "
              f"of {len(names)} params moved by steps 2-3; unmoved "
              f"{sorted(still)}")
        if still - free:
            raise AssertionError(f"params did not move: {sorted(still - free)}")
        del before
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = _elapsed_ms(lambda: step(state, x, mask_ratio=0.9), 5, 1)
        flops = mae_train_flops(**flops_kw) * x.shape[0]
        bound = flops / PEAK_BF16_FLOPS * 1e3
        print(f"train step {name} dec_heads={dec_heads} (mask 0.90, batch "
              f"{x.shape[0]}, bf16): {ms:.3f} ms per step (parent "
              f"{PARENT_STEP_MS[(name, dec_heads)]:.3f}), "
              f"{x.shape[0] / ms * 1e3:.3f} vol/s; bound {bound:.3f} ms "
              f"({flops:.3e} FLOP at {PEAK_BF16_FLOPS:.3e} FLOP/s); "
              f"max_memory_allocated {peak:.2f} GiB")
        del step, state, x, model, tx
        torch.cuda.empty_cache()
    return last


# flash (B1 + B2) against impl="naive" under autograd, the MAE cut to 2 + 2
# blocks: |dloss| / |loss| and max over leaves of max|dgrad| / max|grad|.
# Measured on an H100 at 700 W with these seeds at batch 1: fp32 0 and
# 1.27e-6 (limits: ~8 fp32 ulps for the loss, 2.5x for the gradients);
# bf16 5.1e-6 and 9.0e-3 (limits ~2.5x).  At batch 2, as run here: fp32
# 0 and 1.70e-6, bf16 4.7e-6 and 7.2e-3, all inside the same limits.
TOL_NAIVE = {"float32": (1e-6, 3e-6), "bfloat16": (1.3e-5, 2.2e-2)}
# the ViT-H/14 classifier cut to 2 blocks (4,097 tokens), flash (B3 + B4)
# against impl="naive" under a cross-entropy.  Its loss is taken from the
# model's bf16 logits, so flash and naive logits one bf16 step apart move
# it by ~1e-4 relative: measured on an H100 at 700 W, fp32 9.0e-8 and
# 1.77e-6, bf16 6.9e-5 and 9.9e-3; the bf16 loss limit is ~2.5x.
TOL_NAIVE_CLS = {"float32": (1e-6, 3e-6), "bfloat16": (2e-4, 2.2e-2)}


def check_flash_vs_naive(torch, entry_mod, name, **entry_kw):
    """Phase 8: the same weights, input and noise through the flash path
    and impl="naive", fp32 and bf16."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    noise = torch.rand((2, 5120), generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        _, state, x = entry_mod.train_entry(batch=2, depth=2, decoder_depth=2,
                                            dtype=dtype, **entry_kw)
        model = state.params
        mhas = [m for m in model.modules() if hasattr(m, "attn_impl")]
        res = {}
        for impl in ("auto", "naive"):
            for m in mhas:
                m.attn_impl = impl
            model.zero_grad(set_to_none=True)
            loss = model(x, 0.9, noise)[0]
            loss.backward()
            res[impl] = (loss.item(), {n: p.grad.clone() for n, p in
                                       model.named_parameters()
                                       if p.grad is not None})
        _compare_to_naive(f"MAE {name} {str(dtype)[6:]} (2+2 blocks, 512 / "
                          f"5,121 tokens)", res, dtype)
        del state, x, model, res
        torch.cuda.empty_cache()


def _compare_to_naive(what, res, dtype, tols=TOL_NAIVE,
                      label="flash vs naive"):
    """res: {impl: (loss, {leaf: grad})} -> holds flash ("auto") to naive
    within ``tols``: |dloss| / |loss| and, over leaves, max|dgrad| /
    max|grad|."""
    (lf, gf), (ln, gn) = res["auto"], res["naive"]
    dloss = abs(lf - ln) / abs(ln)
    worst, leaf = max(((gf[n] - gn[n]).abs().max().item()
                       / gn[n].abs().max().item(), n) for n in gn)
    tl, tg = tols[str(dtype).split(".")[1]]
    print(f"{label} {what}: loss {lf:.6f} vs {ln:.6f}, rel "
          f"{dloss:.3e} (tol {tl:.0e}); worst leaf {leaf} rel {worst:.3e} "
          f"(tol {tg:.0e})")
    if not (dloss <= tl and worst <= tg and set(gf) == set(gn)):
        raise AssertionError(f"flash and naive disagree: {what}")


def _check_main_path_shape(torch, fa, name, args, o, lse, do, out, h,
                           scale):
    """B1 and B2 at a main-path shape (B=4, bf16), laid out as the training
    step lays them out, against their plain versions: q, k, v, kc, vc are
    column views of the fused buffer, dO is autograd's [:, 1:] slice after
    the cls concat, and B2 writes into the column views of one dqkv
    buffer.  Returns the max |d| over B2's outputs."""
    o_ref, lse_ref = fa.fwd_packed_plain(*args, h, scale)
    do_o = (o.float() - o_ref.float()).abs()
    atol, rtol = TOL_O["bfloat16"]
    excess = (do_o - rtol * o_ref.float().abs()).max().item()
    dlse = (lse - lse_ref).abs().max().item()
    del o_ref, lse_ref
    print(f"B1 {name} B={o.shape[0]} bf16 as on the main path: max|do|="
          f"{do_o.max().item():.3e} max|dlse|={dlse:.3e}")
    if not (excess <= atol and dlse <= TOL_LSE):
        raise AssertionError(f"B1 disagrees with its plain version at the "
                             f"{name} shape, B={o.shape[0]}")
    ref = fa.bwd_packed_plain(*args, o, lse, do, None, h, scale)
    # each run writes the dqkv views whole; keep the first run's apart
    errs, _ = _grads_twice(
        torch, f"B2 {name} B={o.shape[0]} bf16 as on the main path",
        lambda: tuple(None if t is None else t.clone() for t in
                      fa.bwd_packed_cuda(*args, o, lse, do, None, h, scale,
                                         out=out)), ref, torch.bfloat16)
    return max(errs.values())


def time_flash_bwd(torch, fa, rate):
    """Phase 9, B2 at the encoder's and both decoder geometries' shapes
    (B=4): first held against its plain version as the step lays it out
    (with B1), then timed: kernel, plain version, the library yardstick
    (SDPA forward + backward minus its forward, at the same [B, H, N, D])
    and the bound.  Also B1's time at the decoder shape, against its bound
    with the exps at ``rate``.  Returns the reference decoder's row."""
    import torch.nn.functional as F

    from octcubem_tpu_torch.scripts.time_kernels import bound, fwd_work

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for name, (b, n, h, d) in (("decoder h16", (4, 5121, 16, 32)),
                               ("decoder h4", (4, 5121, 4, 128)),
                               ("encoder", (4, 512, 16, 64))):
        qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        args = _kernel_args(qkv, h)
        cls = args[3] is not None
        scale = d ** -0.5
        o, lse = fa.fwd_packed_cuda(*args, h, scale)
        # autograd's dO: the gradient of the [B, n, H*D] attention output,
        # rows 1: when the cls query row was concatenated in front
        do = torch.randn((b, n, h * d), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        do = do[:, 1:] if cls else do
        dqkv = torch.zeros_like(qkv)
        out = _kernel_args(dqkv, h)
        err = _check_main_path_shape(torch, fa, name, args, o, lse, do, out,
                                     h, scale)
        ms = _elapsed_ms(lambda: fa.bwd_packed_cuda(*args, o, lse, do, None,
                                                    h, scale, out=out), 20)
        fwd_ms = _elapsed_ms(lambda: fa.fwd_packed_cuda(*args, h, scale), 20)
        plain_ms = _elapsed_ms(lambda: fa.bwd_packed_plain(
            *args, o, lse, do, None, h, scale), 3, 1)
        qh, kh, vh = (t.contiguous().requires_grad_() for t in
                      qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4))
        g = torch.randn((b, h, n, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        sdpa_fwd = _elapsed_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale), 20)
        sdpa_all = _elapsed_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qh, kh, vh, scale=scale),
            (qh, kh, vh), g), 20)
        m = n - 1 if cls else n
        keys = m + 1 if cls else m
        es = qkv.element_size()
        flops = 10 * b * h * m * keys * d
        nbytes = (8 * b * m * h * d * es + b * h * m * 4
                  + (4 * b * h * d * es if cls else 0))
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        row = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
               "library_ms": sdpa_all - sdpa_fwd,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        fwd_bound, fwd_by = bound(*fwd_work(b, h, m, keys, d), rate)
        print(f"B2 timing {name} B={b} H={h} N={n} D={d} bf16: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa bwd "
              f"{row['library_ms']:.4f} ms (fwd+bwd {sdpa_all:.4f} - fwd "
              f"{sdpa_fwd:.4f}), bound {row['bound_ms']:.4f} ms ({flops:.3e} "
              f"FLOP -> {t_ops:.4f} ms; {nbytes:.3e} B -> {t_bytes:.4f} ms); "
              f"{flops / ms / 1e9:.1f} TFLOP/s achieved; B1 at this shape "
              f"{fwd_ms:.4f} ms (bound {fwd_bound:.4f} ms by {fwd_by})")
        rows[name] = row
        del qkv, args, o, lse, do, dqkv, out, qh, kh, vh, g
        torch.cuda.empty_cache()
    return rows["decoder h16"]


# ------------------------------------------------ [B, H, N, D]: B3-B5, B7

def _bh_views(qkv, h):
    """q, k, v [B, H, N, D] views of a fused [B, N, 3*H*D] buffer (batch
    stride N*3*H*D, head stride D, row stride 3*H*D), as the packed path
    hands them to flash_attention."""
    b, n, hd3 = qkv.shape
    d = hd3 // (3 * h)
    return [t.transpose(1, 2) for t in qkv.view(b, n, 3, h, d).unbind(2)]


def _bh_args(qkv, h, cls):
    """B3's (cls) or B5's inputs: tokens 1: with row 0 as the cls
    key/value, or all rows."""
    q, k, v = _bh_views(qkv, h)
    if cls:
        return (q[:, :, 1:], k[:, :, 1:], v[:, :, 1:], k[:, :, :1],
                v[:, :, :1])
    return q, k, v, None, None


def _bh_do(torch, gen, b, n, h, d, dtype, cls):
    """autograd's dO for the kernel's rows: the [B, H, N, D] view of a
    [B, N, H, D] gradient (the packed output's), rows 1: after the cls
    query row's concat."""
    do = torch.randn((b, n, h, d), generator=gen, device="cuda",
                     dtype=dtype).transpose(1, 2)
    return do[:, :, 1:] if cls else do


def _hold_bh(torch, fa, what, args, dtype, gen, kv_valid=None, no_max=True):
    """B3 / B5 and B4 / B7 against their plain versions on the same
    inputs: the forward (no_max only) and the backward on the plain
    forward's (o, lse) -- or, for no_max=False, the exact softmax's --
    with autograd's strided dO and a nonzero g_lse.  Returns (max |do|,
    max |d| over the gradients)."""
    q, k, v = args[:3]
    b, h, nq, d = q.shape
    scale = d ** -0.5
    fwd_err = None
    if no_max:
        o, lse = fa.fwd_bh_cuda(*args, scale, kv_valid)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.fwd_bh_plain(*args, scale, kv_valid)
        d_o = (o.float() - o_ref.float()).abs()
        atol, rtol = TOL_O[str(dtype).split(".")[1]]
        excess = (d_o - rtol * o_ref.float().abs()).max().item()
        dlse = (lse - lse_ref).abs().max().item()
        fwd_err = d_o.max().item()
        if not (excess <= atol and dlse <= TOL_LSE
                and torch.isfinite(o.float()).all()):
            raise AssertionError(f"{what}: the forward disagrees with its "
                                 f"plain version (max|do| {fwd_err:.3e}, "
                                 f"max|dlse| {dlse:.3e})")
        del o, lse, d_o
    else:
        kk = k[:, :, :kv_valid] if kv_valid else k
        vv = v[:, :, :kv_valid] if kv_valid else v
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
        lse_ref = torch.logsumexp(s, dim=-1)
        o_ref = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                             vv.float()).to(dtype)
        del s
    cls = args[3] is not None
    do = _bh_do(torch, gen, b, nq + cls, h, d, dtype, cls)
    g_lse = 0.1 * torch.randn(lse_ref.shape, generator=gen, device="cuda")
    ref = fa.bwd_bh_plain(*args, o_ref, lse_ref, do, g_lse, scale, no_max,
                          kv_valid)
    errs, got = _grads_twice(
        torch, f"{what} {str(dtype)[6:]}"
        + (f" (fwd max|do|={fwd_err:.3e})" if no_max else ""),
        lambda: fa.bwd_bh_cuda(*args, o_ref, lse_ref, do, g_lse, scale,
                               no_max, kv_valid), ref, dtype)
    if kv_valid is not None and not bool(
            (got[1][:, :, kv_valid:] == 0).all()
            and (got[2][:, :, kv_valid:] == 0).all()):
        raise AssertionError(f"{what}: dk / dv not 0 past kv_valid")
    return fwd_err, max(errs.values())


def check_bh_kernels(torch, fa):
    """Phase 3, B3-B5 and B7 against their plain versions, bf16 and fp32,
    on the fused buffer's [B, H, N, D] views: the ViT-H/14 classifier
    (B3 / B4) and MAE encoder (B5 / B7) shapes, other head dims, the
    large-logit case, the rectangular kv_valid form (a 4-way query shard
    of the decoder's 5,121 tokens padded to 5,124) and B7's exact-softmax
    branch.  Returns {kernel: max |d|} at the path shapes in bf16."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    errs = {}
    # (name, B, N, H, D, q multiplier)
    cases = [("ViT-H classifier", 1, 4097, 16, 80, 1.0),
             ("ViT-H encoder", 4, 512, 16, 80, 1.0),
             ("D=64", 2, 1025, 8, 64, 1.0), ("D=128", 2, 700, 4, 128, 1.0),
             ("D=32", 2, 513, 8, 32, 1.0), ("D=256", 1, 300, 2, 256, 1.0),
             ("large-logit D=80", 2, 1025, 4, 80, 40.0),
             # ragged: rows and keys not multiples of the one pass's tiles
             ("ragged D=80", 2, 333, 4, 80, 1.0),
             ("ragged D=32", 2, 700, 4, 32, 1.0)]
    for name, b, n, h, d, qmul in cases:
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda")
            qkv[..., :h * d] *= qmul
            qkv = qkv.to(dtype)
            for cls in (False, True):
                kernels = ("B3 + B4" if cls else "B5 + B7")
                fe, be = _hold_bh(torch, fa, f"{kernels} {name} B={b} N={n} "
                                  f"H={h} D={d}", _bh_args(qkv, h, cls),
                                  dtype, gen)
                on_path = (cls, name) in ((True, "ViT-H classifier"),
                                          (False, "ViT-H encoder"))
                if on_path and dtype == torch.bfloat16:
                    errs["B3" if cls else "B5"] = fe
                    errs["B4" if cls else "B7"] = be
            del qkv
            torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        # rect: the decoder's 5,121 tokens padded to 5,124, a 4-way shard
        h, d = 16, 32
        q = torch.randn((1, h, 1281, d), generator=gen, device="cuda")
        k, v = (torch.randn((1, h, 5124, d), generator=gen, device="cuda")
                for _ in range(2))
        _hold_bh(torch, fa, "B5 + B7 rect Nq=1281 Nk=5124 kv_valid=5121 "
                 "H=16 D=32", (q.to(dtype), k.to(dtype), v.to(dtype), None,
                               None), dtype, gen, kv_valid=5121)
        # B7's exact-softmax branch, logits far above the fixed-shift clamp
        qkv = torch.randn((4, 512, 3 * 16 * 80), generator=gen, device="cuda")
        qkv[..., :16 * 80] *= 8.0
        _hold_bh(torch, fa, "B7 no_max=False ViT-H encoder x8 logits",
                 _bh_args(qkv.to(dtype), 16, False), dtype, gen,
                 no_max=False)
        del q, k, v, qkv
    return errs


def run_vith_backward(torch, _cuda, entry_mod):
    """Phase 6: the ViT-H/14 classifier's backward as fine-tuning runs it
    (training mode, the dropout head drawing from a generator; fp32 params,
    bf16 compute) under a cross-entropy: 32 B3 + 32 B4 launches and finite
    gradients.  Then the model cut to 2 blocks (eval mode), flash against
    impl="naive": loss and per-leaf gradients, fp32 and bf16.  Returns the
    B4 launches."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((1, 48, 224, 224, 1), generator=gen, device="cuda")
    label = torch.tensor([3], device="cuda")
    vith = dict(ctor=entry_mod.vit_st.vit_huge_patch14, img_size=224)
    _, (model, _) = entry_mod.entry(**vith)
    model.train()
    _cuda.reset_launches()
    loss = F.cross_entropy(model(x, torch.Generator(device="cuda")
                                 .manual_seed(8)).float(), label)
    loss.backward()
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    print(f"ViT-H classifier backward (48x224x224, train mode, bf16 "
          f"compute): loss {loss.item():.6f}, {len(grads)} leaves with "
          f"gradients, finite {finite}, launches {_nonzero(launches)}")
    depth = len(model.blocks)
    if _nonzero(launches) != {"flash_fwd_bh_cls": depth,
                              "flash_bwd_bh_cls": depth} or not finite:
        raise AssertionError(f"expected {depth} B3 + {depth} B4 launches and "
                             f"finite gradients, got {launches}")
    del model, grads, loss
    torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        _, (model, _) = entry_mod.entry(**vith, depth=2,
                                        dtype=dtype)
        mhas = [m for m in model.modules() if hasattr(m, "attn_impl")]
        res = {}
        for impl in ("auto", "naive"):
            for m in mhas:
                m.attn_impl = impl
            model.zero_grad(set_to_none=True)
            loss = F.cross_entropy(model(x).float(), label)
            loss.backward()
            res[impl] = (loss.item(), {n: p.grad.clone() for n, p in
                                       model.named_parameters()
                                       if p.grad is not None})
        _compare_to_naive(f"ViT-H classifier {str(dtype)[6:]} (2 blocks, "
                          f"4,097 tokens)", res, dtype, TOL_NAIVE_CLS)
        del model, res
        torch.cuda.empty_cache()
    return launches["flash_bwd_bh_cls"]


def time_bh_kernels(torch, fa, rate):
    """Phase 9, B3-B5 and B7 at the ViT-H paths' shapes (bf16, laid out as
    the paths lay them out), timed: kernel, plain version, the library
    yardstick (SDPA at the same [B, H, N, D]: its forward for B3 and B5,
    forward + backward minus forward for B4 and B7) and the bound (the
    forwards' with their exps at ``rate``).  Returns {kernel: row}."""
    import torch.nn.functional as F

    from octcubem_tpu_torch.scripts.time_kernels import bound, fwd_work

    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = {}
    for path, (b, n, h, d), cls in (("ViT-H classifier", (1, 4097, 16, 80), True),
                                    ("ViT-H encoder", (4, 512, 16, 80), False)):
        fwd, bwd = ("B3", "B4") if cls else ("B5", "B7")
        qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        args = _bh_args(qkv, h, cls)
        scale = d ** -0.5
        o, lse = fa.fwd_bh_cuda(*args, scale)
        do = _bh_do(torch, gen, b, n, h, d, torch.bfloat16, cls)
        _grads_twice(torch, f"{bwd} {path} B={b} bf16 as on the main path",
                     lambda: fa.bwd_bh_cuda(*args, o, lse, do, None, scale),
                     fa.bwd_bh_plain(*args, o, lse, do, None, scale),
                     torch.bfloat16)
        t = {fwd: _elapsed_ms(lambda: fa.fwd_bh_cuda(*args, scale), 50),
             bwd: _elapsed_ms(lambda: fa.bwd_bh_cuda(*args, o, lse, do, None,
                                                     scale), 20)}
        plain = {fwd: _elapsed_ms(lambda: fa.fwd_bh_plain(*args, scale), 3, 1),
                 bwd: _elapsed_ms(lambda: fa.bwd_bh_plain(
                     *args, o, lse, do, None, scale), 3, 1)}
        qh, kh, vh = (x.contiguous().requires_grad_() for x in
                      _bh_views(qkv, h))
        g = torch.randn((b, h, n, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        sdpa_fwd = _elapsed_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale), 50)
        sdpa_all = _elapsed_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qh, kh, vh, scale=scale),
            (qh, kh, vh), g), 20)
        lib = {fwd: sdpa_fwd, bwd: sdpa_all - sdpa_fwd}
        m = n - 1 if cls else n          # query rows of the kernels
        keys = m + 1 if cls else m
        es = qkv.element_size()
        elems = b * m * h * d            # one [B, H, m, D] operand
        work = {fwd: fwd_work(b, h, m, keys, d),
                bwd: (10 * b * h * m * keys * d,
                      (3 * b * n * h * d + 2 * elems + 3 * elems) * es
                      + 2 * b * h * m * 4 + (2 * b * h * d * es if cls else 0),
                      0)}
        for kern in (fwd, bwd):
            flops, nbytes, exps = work[kern]
            bound_ms, bound_by = bound(flops, nbytes, exps, rate)
            rows[kern] = {"ms": t[kern], "plain_ms": plain[kern],
                          "library_ms": lib[kern], "bound_ms": bound_ms,
                          "bound_by": bound_by}
            print(f"{kern} timing {path} B={b} H={h} N={n} D={d} bf16: kernel "
                  f"{t[kern]:.4f} ms, plain {plain[kern]:.4f} ms, sdpa "
                  f"{'fwd' if kern == fwd else 'bwd'} {lib[kern]:.4f} ms, "
                  f"bound {bound_ms:.4f} ms by {bound_by} ({flops:.3e} FLOP, "
                  f"{nbytes:.3e} B, {exps:.3e} exp); "
                  f"{flops / t[kern] / 1e9:.1f} TFLOP/s achieved")
        del qkv, args, o, lse, do, qh, kh, vh, g
        torch.cuda.empty_cache()
    return rows


def time_forward(torch, fn, model, x, name):
    ms = _elapsed_ms(lambda: fn(model, x), 20)
    u, p = model.t_patch_size, model.patch_size
    n = 1 + x.shape[1] // u * (x.shape[2] // p) ** 2
    dim, depth = model.head.weight.shape[1], len(model.blocks)
    flops = depth * (2 * n * 12 * dim * dim + 4 * n * n * dim) \
        + 2 * (n - 1) * u * p * p * dim
    print(f"entry forward ({name} bf16, batch 1): {ms:.3f} ms per "
          f"volume; {flops:.3e} FLOP -> bound {flops / PEAK_BF16_FLOPS * 1e3:.3f} "
          f"ms at {PEAK_BF16_FLOPS:.3e} FLOP/s")
    return ms


# ----------------------------------------------------- B6: exact softmax

def _hold(torch, what, got, ref, dtype, atol=None):
    """|got - ref| <= atol + rtol |ref| at TOL_O[dtype] (``atol`` given:
    in place of TOL_O's) -> max |d|."""
    d = (got.float() - ref.float()).abs()
    atol0, rtol = TOL_O[str(dtype).split(".")[1]]
    atol = atol0 if atol is None else atol
    excess = (d - rtol * ref.float().abs()).max().item()
    if not (excess <= atol and torch.isfinite(got.float()).all()):
        raise AssertionError(f"{what}: max|d| {d.max().item():.3e} over "
                             f"{atol:.1e} + {rtol:.1e}|ref|")
    return d.max().item()


def _grads_close(torch, what, got, ref, dtype):
    """Each |got - ref| <= TOL_GRAD[dtype] * max|ref| -> the worst ratio."""
    tol = TOL_GRAD[str(dtype).split(".")[1]]
    worst = 0.0
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        rel = ((a.float() - r.float()).abs().max().item()
               / max(r.float().abs().max().item(), 1e-30))
        worst = max(worst, rel)
        if not (rel <= tol and torch.isfinite(a.float()).all()):
            raise AssertionError(f"{what}: {name} rel {rel:.3e} over {tol:.1e}")
    return worst


def _body_of(torch, fn):
    """Which forward body one call of fn runs: the name, up to its '<', of
    the one forward kernel in a profile of the call (after a call outside
    the profile, which loads the kernel).  A profile that records no
    device kernel (seen now and then on the first profile of a process)
    is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()}
        bodies = {n.split("<")[0].split("::")[-1] for n in names
                  if "fwd_" in n and "_kernel" in n}
        if bodies:
            break
    if len(bodies) != 1:
        raise AssertionError(f"expected one forward kernel, ran {names}")
    return bodies.pop()


def check_b6(torch, fa, naive):
    """Phase 10: B6 against fwd_bh_exact_plain, fp32 and bf16, on the body
    each case should run (bf16 at D <= 128 the Hopper body, found by name
    in a profile of the call), each call made twice with o and lse
    bit-identical; then B6 + B7 (exact branch) under autograd against the
    plain versions.  The rect cases hold NaN in k and v past kv_valid for
    the forward (the gradients take finite tails).  Returns max |do| at
    the decoder shape in bf16."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    # (name, B, Nq, Nk, kv_valid, H, D, q multiplier, k multiplier); square
    # cases read the fused buffer's [B, H, N, D] views; every N ragged
    # against the 128-key and 128-row tiles
    cases = [("decoder D=32", 4, 5121, 5121, None, 16, 32, 1.0, 1.0),
             ("D=64", 2, 1025, 1025, None, 8, 64, 1.0, 1.0),
             ("ViT-H D=80", 1, 4097, 4097, None, 16, 80, 1.0, 1.0),
             ("D=128", 2, 513, 513, None, 4, 128, 1.0, 1.0),
             ("D=256", 1, 300, 300, None, 2, 256, 1.0, 1.0),
             ("decoder shard rect D=32", 4, 1281, 5124, 5121, 16, 32, 1.0,
              1.0),
             ("rect D=80", 2, 300, 1000, 950, 4, 80, 1.0, 1.0),
             ("large-logit q, k x 8 D=80", 2, 1025, 1025, None, 4, 80, 8.0,
              8.0),
             ("large-logit q, k x 8 rect D=64", 2, 200, 700, 650, 4, 64, 8.0,
              8.0),
             ("large-logit q x 40 D=32", 2, 1025, 1025, None, 4, 32, 40.0,
              1.0),
             ("large-logit q x 40 rect D=128", 2, 333, 700, 651, 4, 128, 40.0,
              1.0)]
    dec_err = None
    for name, b, nq, nk, kv, h, d, qmul, kmul in cases:
        mul = qmul * kmul
        for dtype in (torch.bfloat16, torch.float32):
            scale = d ** -0.5
            if nq == nk:
                qkv = torch.randn((b, nq, 3 * h * d), generator=gen,
                                  device="cuda")
                qkv[..., :h * d] *= qmul
                qkv[..., h * d:2 * h * d] *= kmul
                q, k, v = _bh_views(qkv.to(dtype), h)
                kn, vn = k, v
            else:
                q = qmul * torch.randn((b, h, nq, d), generator=gen,
                                       device="cuda")
                k, v = (torch.randn((b, h, nk, d), generator=gen,
                                    device="cuda") for _ in range(2))
                q, k, v = q.to(dtype), (kmul * k).to(dtype), v.to(dtype)
                kn, vn = k.clone(), v.clone()
                kn[:, :, kv:], vn[:, :, kv:] = math.nan, math.nan

            def call():
                return fa.fwd_bh_cuda(q, kn, vn, None, None, scale, kv, False)

            body = _body_of(torch, call)
            want = ("fwd_f32_kernel" if dtype == torch.float32 else
                    "fwd_hopper_kernel" if d <= 128 else "fwd_bf16_kernel")
            if body != want:
                raise AssertionError(f"B6 {name} {dtype} ran {body}, not "
                                     f"{want}")
            (o, lse), (o2, lse2) = call(), call()
            torch.cuda.synchronize()
            same = torch.equal(o, o2) and torch.equal(lse, lse2)
            if not same:
                raise AssertionError(f"B6 {name} {dtype}: two calls differ")
            o_ref, lse_ref = fa.fwd_bh_exact_plain(q, k, v, scale, kv)
            # large logits (q, k x 8; q x 40), where a few keys carry each
            # row:
            # - bf16: the kernel rounds p relative to its running max, the
            #   plain version (and naive) relative to the row max or after
            #   normalising, each to 2^-9 of p, so o may differ by 2^-8 of
            #   the weighted |v| on top of o's own rounding; TOL_O's floor
            #   assumes many small p whose roundings average out;
            # - fp32: a logit of size L (max|lse| ~ max L, ~370) carries an
            #   absolute rounding error of a few ulps of L, which moves p
            #   by that much relative and o by that times |v|: 4 ulps of
            #   max|lse| times max|v|, at least TOL_O's.
            big = None
            if mul > 1.0:
                vmax = (v[:, :, :kv] if kv else v).float().abs().max().item()
                big = (2 ** -8 * vmax if dtype == torch.bfloat16 else
                       max(TOL_O["float32"][0], 4 * 2 ** -23 * vmax
                           * lse_ref.abs().max().item()))
            err = _hold(torch, f"B6 {name} {dtype}", o, o_ref, dtype, big)
            # lse = m + log l, rounded at its own magnitude: TOL_LSE, or 8
            # fp32 ulps where |lse| is large (~300 at the large logits,
            # whose ulp is 3.05e-5)
            dlse = (lse - lse_ref).abs().max().item()
            tol_lse = max(TOL_LSE, 8 * 2 ** -23 * lse_ref.abs().max().item())
            if dlse > tol_lse:
                raise AssertionError(f"B6 {name} {dtype}: max|dlse| {dlse}")
            line = (f"B6 {name} B={b} Nq={nq} Nk={nk} kv_valid={kv} H={h} "
                    f"D={d} {str(dtype)[6:]} ({body}"
                    f"{', NaN tail' if kv else ''}): max|do|={err:.3e} "
                    f"max|dlse|={dlse:.3e} (tol {tol_lse:.1e}); two calls "
                    f"bit-identical")
            if mul > 1.0:
                kk, vv = (t[:, :, :kv] if kv else t for t in (k, v))
                ref = naive(q, kk, vv, scale=scale)
                e6 = _hold(torch, f"B6 vs naive {name} {dtype}", o, ref, dtype,
                           big)
                o5, _ = fa.fwd_bh_cuda(q, k, v, None, None, scale, kv)
                e5 = (o5.float() - ref.float()).abs().max().item()
                if e5 <= 10 * max(e6, big):
                    raise AssertionError(f"B5 agrees with naive at {name}: "
                                         "the case does not pass the clamp")
                line += (f"; vs naive: B6 {e6:.3e}, B5 (fixed shift) "
                         f"{e5:.3e}")
                del o5
            print(line)
            if name == "decoder D=32" and dtype == torch.bfloat16:
                dec_err = err
            # B6 + B7 (exact) under autograd, against the plain versions
            # (the plain backward on the plain forward's o and lse)
            g = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
            _, grads = _attn_grads(torch, lambda *a: fa.flash_attention_rect(
                *a, scale, False, kv), q, k, v, g)
            ref = fa.bwd_bh_plain(q, k, v, None, None, o_ref, lse_ref, g, None,
                                  scale, False, kv)
            rel = _grads_close(torch, f"B6 + B7 {name} {dtype}", grads, ref,
                               dtype)
            print(f"B6 + B7 exact {name} {str(dtype)[6:]}: gradients against "
                  f"the plain versions, worst rel {rel:.3e} (tol "
                  f"{TOL_GRAD[str(dtype)[6:]]:.1e} x max|plain|)")
            del q, k, v, kn, vn, o, lse, o2, lse2, o_ref, lse_ref, g, grads
            del ref
        torch.cuda.empty_cache()
    return dec_err


# ------------------------------------------- the sequence-parallel layer

def _attn_grads(torch, fn, q, k, v, g):
    """fn(q, k, v) and its q, k, v gradients under the cotangent g."""
    ts = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, g)
    return out.detach(), grads


def run_sp_one_rank(torch, _cuda, fa, sp, layers):
    """Phase 11 on a one-rank NCCL group: the sp and ring layers against
    unsharded flash_attention; then the decoder stack under flash_sp
    against flash.  Returns the launches of the layer runs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1),
                            rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("sp",))
        gen = torch.Generator(device="cuda").manual_seed(11)
        b, h, n, d = 4, 16, 5121, 32
        q, k, v, g = (torch.randn((b, h, n, d), generator=gen, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(4))
        _cuda.reset_launches()
        runs = {
            "sequence_parallel_attention no_max=True": (
                lambda *a: sp.sequence_parallel_attention(*a, mesh),
                lambda *a: fa.flash_attention(*a)),
            "sequence_parallel_attention no_max=False": (
                lambda *a: sp.sequence_parallel_attention(*a, mesh,
                                                          no_max=False),
                lambda *a: fa.flash_attention(*a, no_max=False)),
            "ring_attention": (lambda *a: sp.ring_attention(*a, mesh),
                               lambda *a: fa.flash_attention(*a))}
        results = {}
        for name, (fn, ref_fn) in runs.items():
            results[name] = _attn_grads(torch, fn, q, k, v, g)
        torch.cuda.synchronize()
        launches = dict(_cuda.launches)
        for name, (fn, ref_fn) in runs.items():
            out, grads = results[name]
            out_ref, grads_ref = _attn_grads(torch, ref_fn, q, k, v, g)
            err = _hold(torch, f"{name} forward", out, out_ref, torch.bfloat16)
            rel = _grads_close(torch, name, grads, grads_ref, torch.bfloat16)
            print(f"one-rank NCCL {name} [4, 16, 5121, 32] bf16 vs unsharded "
                  f"flash_attention: max|do|={err:.3e}, gradients worst rel "
                  f"{rel:.3e}")
        print(f"one-rank NCCL layer launches: {_nonzero(launches)}")
        want = {"flash_fwd_bh": 2, "flash_fwd_bh_exact": 1, "flash_bwd_bh": 3}
        if _nonzero(launches) != want:
            raise AssertionError(f"expected {want}, got {launches}")
        del q, k, v, g, results

        # the decoder's stack at full width, flash_sp against flash
        torch.manual_seed(12)
        stack = layers.TransformerStack(8, 512, 16, dtype=torch.bfloat16,
                                        parity="flash").cuda()
        x = torch.randn((4, 5121, 512), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        res, stack_launches = {}, {}
        for impl in ("flash_sp", "flash"):
            for m in stack.modules():
                if hasattr(m, "attn_impl"):
                    m.attn_impl = impl
            stack.zero_grad(set_to_none=True)
            _cuda.reset_launches()
            with sp.use_sequence_parallel(mesh, "sp"):
                loss = (stack(x).float() ** 2).mean()
                loss.backward()
            torch.cuda.synchronize()
            stack_launches[impl] = _nonzero(_cuda.launches)
            res["auto" if impl == "flash_sp" else "naive"] = (
                loss.item(), {nm: p.grad.clone() for nm, p in
                              stack.named_parameters()})
        print(f"decoder stack launches: {stack_launches}")
        if stack_launches != {
                "flash_sp": {"flash_fwd_bh": 8, "flash_bwd_bh": 8},
                "flash": {"flash_fwd_packed": 8, "flash_bwd_packed": 8}}:
            raise AssertionError(f"unexpected launches {stack_launches}")
        _compare_to_naive("decoder TransformerStack(8, 512, 16) bf16, 5,121 "
                          "tokens, batch 4", res, torch.bfloat16,
                          label="flash_sp vs flash")
        for k_, c in stack_launches["flash_sp"].items():
            launches[k_] = launches.get(k_, 0) + c
        del stack, x, res
        torch.cuda.empty_cache()
        return launches
    finally:
        dist.destroy_process_group()


def run_sp_shards(torch, _cuda, fa):
    """Phase 12: the 4-shard geometry of a vitl_joint_pretrain_sp4 run on
    one card, each rank's local body in turn.  Returns the launches."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    b, h, n, n_pad, d, n_sp = 4, 16, 5121, 5124, 32, 4
    n_loc = n_pad // n_sp
    q0, k0, v0, g = (torch.randn((b, h, n_pad, d), generator=gen,
                                 device="cuda", dtype=torch.bfloat16)
                     for _ in range(4))
    g[:, :, n:] = 0  # the loss reads the valid rows only
    keep = (torch.arange(n_pad, device="cuda") < n)[:, None]
    launches = {}
    for no_max in (True, False):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        km, vm = torch.where(keep, k, 0), torch.where(keep, v, 0)
        _cuda.reset_launches()
        outs, grads = [], [torch.zeros(t.shape, device="cuda")
                           for t in (q, k, v)]
        for r in range(n_sp):
            rows = slice(r * n_loc, (r + 1) * n_loc)
            o = fa.flash_attention_rect(q[:, :, rows], km, vm, no_max=no_max,
                                        kv_valid=n)
            for acc, gr in zip(grads, torch.autograd.grad(
                    o, (q, k, v), g[:, :, rows], retain_graph=True)):
                acc += gr.float()
            outs.append(o.detach())
        torch.cuda.synchronize()
        for key, c in _nonzero(_cuda.launches).items():
            launches[key] = launches.get(key, 0) + c
        out = torch.cat(outs, dim=2)
        ref_out, ref_grads = _attn_grads(
            torch, lambda a, b_, c: fa.flash_attention(a, b_, c,
                                                       no_max=no_max),
            q0[:, :, :n], k0[:, :, :n], v0[:, :, :n], g[:, :, :n])
        err = _hold(torch, f"4 shards no_max={no_max}", out[:, :, :n],
                    ref_out, torch.bfloat16)
        rel = _grads_close(torch, f"4 shards no_max={no_max}",
                           [t[:, :, :n] for t in grads], ref_grads,
                           torch.bfloat16)
        pad_zero = all(bool((t[:, :, n:] == 0).all()) for t in grads)
        print(f"4 shards of 1,281 rows x 5,124 keys (kv_valid 5,121), "
              f"no_max={no_max}, bf16: concatenated output vs unsharded "
              f"max|do|={err:.3e}; summed gradients worst rel {rel:.3e}; pad "
              f"rows' gradients exactly 0: {pad_zero}")
        if not pad_zero:
            raise AssertionError("pad rows got a nonzero gradient")
        del q, k, v, km, vm, outs, grads, out, ref_out, ref_grads
    print(f"4-shard launches: {launches}")
    want = {"flash_fwd_bh": 4, "flash_fwd_bh_exact": 4, "flash_bwd_bh": 8}
    if launches != want:
        raise AssertionError(f"expected {want}, got {launches}")
    return launches


# ------------------------------------------------------ B8 and timings

def check_b8(torch, kablate):
    """Phase 13: B8, every flag variant at every tile of the Hopper body,
    against its plain version at the harness's shape, each at its own
    padding; the base variant's call is profiled to show the body it ran.
    Returns max |do| of base at the base tile."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    q, k, v = (torch.randn((kablate.BH, kablate.N, kablate.D), generator=gen,
                           device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    runs = [(name, tile) for tile in kablate.TILES
            for name in kablate.VARIANTS]
    body = _body_of(torch, lambda: kablate.fwd_variant_cuda(q, k, v))
    print(f"B8 base {kablate.BASE_TILE} runs {body}")
    if body != "fwd_hopper_kernel":
        raise AssertionError(f"B8 ran {body}, not the Hopper body")
    base_err = None
    for name, tile in runs:
        flags = kablate.VARIANTS[name]
        o, lse = kablate.fwd_variant_cuda(q, k, v, tile, **flags)
        torch.cuda.synchronize()
        o_ref, lse_ref = kablate.fwd_variant_plain(
            q, k, v, kablate.n_pad_of(kablate.N, tile), kablate.TILES[tile][2],
            **flags)
        err = (o.float() - o_ref.float()).abs().max().item()
        top = o_ref.float().abs().max().item()
        lerr = (lse - lse_ref).abs().max().item()
        ltop = max(lse_ref.abs().max().item(), 1e-30)
        print(f"B8 {name} {tile} BH={kablate.BH} N={kablate.N} D={kablate.D} "
              f"bf16: max|do|={err:.3e} (tol 2^-7 x max|plain| = "
              f"{2 ** -7 * top:.3e}), max|dl|={lerr:.3e} (tol 1e-4 x "
              f"{ltop:.3e})")
        if not (err <= 2 ** -7 * top and lerr <= 1e-4 * ltop
                and torch.isfinite(o.float()).all()):
            raise AssertionError(f"B8 {name} {tile} disagrees with its plain "
                                 "version")
        if (name, tile) == ("base", kablate.BASE_TILE):
            base_err = err
        del o, lse, o_ref, lse_ref
        torch.cuda.empty_cache()
    return base_err


def _row(ms, plain_ms, library_ms, work, rate):
    """A forward's row: its times and its bound from ``work`` = (FLOP,
    bytes, exps) at ``rate`` exps per second."""
    from octcubem_tpu_torch.scripts.time_kernels import bound

    bound_ms, bound_by = bound(*work, rate)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def time_b6(torch, fa, rate):
    """Phase 14, B6 at the decoder's square shape (the fused buffer's
    views) and at the 4-shard shape: kernel, plain version, SDPA at the
    same [B, H, N, D], the bound, and the parent's body's time
    (PARENT_B6_MS).  Returns the square shape's row."""
    import torch.nn.functional as F

    from octcubem_tpu_torch.scripts.time_kernels import fwd_work

    gen = torch.Generator(device="cuda").manual_seed(15)
    b, h, n, d = 4, 16, 5121, 32
    scale = d ** -0.5
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    q, k, v = _bh_views(qkv, h)
    ms = _elapsed_ms(lambda: fa.fwd_bh_cuda(q, k, v, None, None, scale, None,
                                            False), 20)
    plain_ms = _elapsed_ms(lambda: fa.fwd_bh_exact_plain(q, k, v, scale), 3, 1)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    sdpa = _elapsed_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, scale=scale), 20)
    row = _row(ms, plain_ms, sdpa, fwd_work(b, h, n, n, d), rate)
    print(f"B6 timing decoder square B={b} H={h} N={n} D={d} bf16: kernel "
          f"{ms:.4f} ms (the parent's mma.sync body "
          f"{PARENT_B6_MS['square']:.4f}), plain {plain_ms:.4f} ms, sdpa "
          f"{sdpa:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}); {4 * b * h * n * n * d / ms / 1e9:.1f} "
          "TFLOP/s achieved")
    del qkv, q, k, v, qc, kc, vc
    nq, nk, kv = 1281, 5124, 5121
    q = torch.randn((b, h, nq, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randn((b, h, nk, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    ms_s = _elapsed_ms(lambda: fa.fwd_bh_cuda(q, k, v, None, None, scale, kv,
                                              False), 20)
    plain_s = _elapsed_ms(lambda: fa.fwd_bh_exact_plain(q, k, v, scale, kv),
                          3, 1)
    kk, vv = k[:, :, :kv].contiguous(), v[:, :, :kv].contiguous()
    sdpa_s = _elapsed_ms(lambda: F.scaled_dot_product_attention(
        q, kk, vv, scale=scale), 20)
    shard = _row(ms_s, plain_s, sdpa_s, fwd_work(b, h, nq, kv, d), rate)
    print(f"B6 timing shard rect B={b} H={h} Nq={nq} Nk={nk} kv_valid={kv} "
          f"D={d} bf16: kernel {ms_s:.4f} ms (the parent's mma.sync body "
          f"{PARENT_B6_MS['shard']:.4f}), plain {plain_s:.4f} ms, sdpa "
          f"{sdpa_s:.4f} ms, bound {shard['bound_ms']:.4f} ms "
          f"({shard['bound_by']})")
    return row


def time_b8(torch, _cuda, kablate, rate):
    """Phase 13, then: the harness's timings (every variant, the tiles and
    a b* variant) with the launch count of its run; B8 base's plain
    version and SDPA at the same inputs viewed as [4, 16, N, D] (the base
    variant is attention up to the pad keys' e^-16 mass).  Returns B8's
    row."""
    import torch.nn.functional as F

    names = list(kablate.VARIANTS) + [t for t in kablate.TILES
                                      if t != kablate.BASE_TILE] + ["bwd"]
    _cuda.reset_launches()
    times = kablate.main(names)
    torch.cuda.synchronize()
    launches = _cuda.launches["flash_ablate"]
    print(f"kablate harness launches: {_nonzero(_cuda.launches)}")
    if not launches:
        raise AssertionError("the harness launched no B8")
    gen = torch.Generator(device="cuda").manual_seed(16)
    bh, n, d = kablate.BH, kablate.N, kablate.D
    q, k, v = (torch.randn((bh, n, d), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    plain_ms = _elapsed_ms(lambda: kablate.fwd_variant_plain(
        q, k, v, kablate.n_pad_of(n), kablate.TILES[kablate.BASE_TILE][2]),
        3, 1)
    q4, k4, v4 = (t.view(4, bh // 4, n, d) for t in (q, k, v))
    sdpa = _elapsed_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, scale=d ** -0.5), 20)
    from octcubem_tpu_torch.scripts.time_kernels import fwd_work

    row = _row(times["base"], plain_ms, sdpa, fwd_work(1, bh, n, n, d), rate)
    print(f"B8 base timing BH={bh} N={n} D={d} bf16: kernel {row['ms']:.4f} "
          f"ms (the harness's), plain {plain_ms:.4f} ms, sdpa {sdpa:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return dict(row, launches=launches)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "octcubem_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the octcubem_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from octcubem_tpu_torch import entry as entry_mod
    from octcubem_tpu_torch.cli import serve
    from octcubem_tpu_torch.nn import layers
    from octcubem_tpu_torch.ops import _cuda
    from octcubem_tpu_torch.ops import flash_attention as fa
    from octcubem_tpu_torch.ops.attention import naive_attention
    from octcubem_tpu_torch.parallel import sequence as sp
    from octcubem_tpu_torch.scripts import kablate
    from octcubem_tpu_torch.scripts.time_kernels import exp_rate
    from octcubem_tpu_torch.train import optim

    # full-fp32 matmuls and convolutions for the fp32 comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi)
    rate = exp_rate(torch)
    print(f"exp rate {rate:.4e} per second (16 per clock per SM, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs, "
          f"the max SM clock)")

    t0 = time.time()
    _cuda.build()
    print(f"kernels built in {time.time() - t0:.1f} s")
    clock = [time.time()]

    def phase_done(name):
        now = time.time()
        print(f"[phase] {name}: {now - clock[0]:.1f} s")
        clock[0] = now

    # per kernel: its name, registers, spills, and any wgmma serialised
    for name in _cuda.KERNELS:
        for line in _cuda.build_log(name).read_text().splitlines():
            if any(w in line for w in ("entry function", "registers", "spill",
                                       "error", "warning", "wgmma")):
                print(f"ptxas {name}: {line.strip()}")

    err = check_flash_fwd(torch, fa)
    check_hopper_fwd(torch, fa)
    check_flash_bwd(torch, fa)
    bh_errs = check_bh_kernels(torch, fa)
    phase_done("3: B1-B5, B7 against their plain versions")

    # serving: ViT-L (B1), the server, then ViT-H/14 (B3)
    fn, model, x, launches = run_main_path(torch, _cuda, entry_mod)
    run_serve(torch, _cuda, serve)
    timing = time_flash_fwd(torch, fa, rate)
    time_forward(torch, fn, model, x, "ViT-L 48x256x256")
    del fn, model, x
    phase_done("4-5: ViT-L serving and the server")
    vith = dict(ctor=entry_mod.vit_st.vit_huge_patch14, img_size=224)
    fn, model, x, b3_launches = run_main_path(
        torch, _cuda, entry_mod, name="ViT-H/14 48x224x224",
        counter="flash_fwd_bh_cls", **vith)
    time_forward(torch, fn, model, x, "ViT-H/14 48x224x224")
    del fn, model, x
    torch.cuda.empty_cache()
    b4_launches = run_vith_backward(torch, _cuda, entry_mod)
    phase_done("6: ViT-H/14 classifier")

    # training: ViT-L/16 (B1 + B2), then ViT-H/14 (B5 + B7, B1 + B2)
    launches_bwd = run_train(
        torch, _cuda, entry_mod, optim, "ViT-L/16 60x256x256", (16, 4),
        {"flash_fwd_packed": 32, "flash_bwd_packed": 32}, {})[
            "flash_bwd_packed"]
    check_flash_vs_naive(torch, entry_mod, "ViT-L/16")
    mae_h = dict(ctor=entry_mod.mae3d.mae_vit_huge_patch14, input_size=224)
    b57 = run_train(
        torch, _cuda, entry_mod, optim, "ViT-H/14 60x224x224", (16,),
        {"flash_fwd_bh": 32, "flash_bwd_bh": 32, "flash_fwd_packed": 8,
         "flash_bwd_packed": 8},
        dict(d=1280, layers=32, img=224, patch=14), **mae_h)
    check_flash_vs_naive(torch, entry_mod, "ViT-H/14", **mae_h)
    phase_done("7-8: MAE steps and flash vs naive")

    timing_bwd = time_flash_bwd(torch, fa, rate)
    timing_bh = time_bh_kernels(torch, fa, rate)
    phase_done("9: B1-B5, B7 timings")

    # the exact softmax (B6) and the sequence-parallel layer
    b6_err = check_b6(torch, fa, naive_attention)
    phase_done("10: B6 against its plain version")
    sp_launches = run_sp_one_rank(torch, _cuda, fa, sp, layers)
    phase_done("11: the sp layer on a one-rank NCCL group")
    run_sp_shards(torch, _cuda, fa)
    phase_done("12: the 4-shard geometry")
    b8_err = check_b8(torch, kablate)
    timing_b8 = time_b8(torch, _cuda, kablate, rate)
    phase_done("13: B8 and the ablation harness")
    timing_b6 = time_b6(torch, fa, rate)
    phase_done("14: B6 timings")

    kernels = [{
        "name": "flash_fwd_packed", "route": "cuda",
        "source": "octcubem_tpu_torch/csrc/flash_fwd_packed.cu",
        "replaces": "octcubem_tpu/ops/flash_attention.py:859",
        "launches": launches, "max_abs_err": err, **timing}, {
        "name": "flash_bwd_packed", "route": "cuda",
        "source": "octcubem_tpu_torch/csrc/flash_bwd_packed.cu",
        "replaces": "octcubem_tpu/ops/flash_attention.py:961",
        "launches": launches_bwd, **timing_bwd}]
    # (counter, TPU kernel's line, source, launches on its path)
    for kern, counter, line, src, n in (
            ("B3", "flash_fwd_bh_cls", 128, "flash_fwd_bh.cu", b3_launches),
            ("B4", "flash_bwd_bh_cls", 397, "flash_bwd_bh.cu", b4_launches),
            ("B5", "flash_fwd_bh", 91, "flash_fwd_bh.cu", b57["flash_fwd_bh"]),
            ("B7", "flash_bwd_bh", 329, "flash_bwd_bh.cu",
             b57["flash_bwd_bh"])):
        kernels.append({
            "name": counter, "route": "cuda",
            "source": f"octcubem_tpu_torch/csrc/{src}",
            "replaces": f"octcubem_tpu/ops/flash_attention.py:{line}",
            "launches": n, "max_abs_err": bh_errs[kern], **timing_bh[kern]})
    kernels.append({
        "name": "flash_fwd_bh_exact", "route": "cuda",
        "source": "octcubem_tpu_torch/csrc/flash_fwd_bh.cu",
        "replaces": "octcubem_tpu/ops/flash_attention.py:170",
        "launches": sp_launches["flash_fwd_bh_exact"], "max_abs_err": b6_err,
        **timing_b6})
    kernels.append({
        "name": "flash_ablate", "route": "cuda",
        "source": "octcubem_tpu_torch/csrc/flash_ablate.cu",
        "replaces": "scripts/kablate.py:33", "max_abs_err": b8_err,
        **timing_b8})
    for k in kernels:
        for key, val in k.items():
            if isinstance(val, float) and not math.isfinite(val):
                raise AssertionError(f"{k['name']}: {key} is {val}")
        # the SFU's exps are operations too: the line names two kinds
        if k["bound_by"] == "exp":
            k["bound_by"] = "operations"
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
