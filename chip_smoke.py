#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (octcubem_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase's error is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from csrc/ (nvcc, one process per source);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path and its neighbours give it, bf16 and fp32,
     plus a large-logit case, within stated tolerances;
  4. the main path: entry()'s ViT-L 48x256x256 bf16 forward, its launch
     counts, finite [1, 16] logits that agree with the same model run
     with impl="naive";
  5. serving: cli/serve.py's server in a thread with the ViT-L model,
     /healthz and four /predict requests;
  6. timings with CUDA events (kernel, plain version, a PyTorch library
     yardstick, the bound, the forward), then one {"kernels": [...]} line.
The last line is {"ok": true, "device": {...}}.  Exits non-zero with no
result when there is no CUDA device or no port package beside it.
"""

from __future__ import annotations

import io
import json
import math
import subprocess
import sys
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


def run_main_path(torch, _cuda, entry_mod):
    """Phase 4: entry()'s forward through the kernels."""
    fn, (model, x) = entry_mod.entry()
    _cuda.reset_launches()
    logits = fn(model, x)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    print(f"entry forward: logits {list(logits.shape)} {logits.dtype}, "
          f"launches {launches}")
    if tuple(logits.shape) != (1, 16) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits {logits}")
    depth = len(model.blocks)
    if launches["flash_fwd_packed"] != depth:
        raise AssertionError(f"expected {depth} B1 launches, got {launches}")

    mhas = [m for m in model.modules() if hasattr(m, "attn_impl")]
    for m in mhas:
        m.attn_impl = "naive"
    ref = fn(model, x)
    for m in mhas:
        m.attn_impl = "auto"
    err = (logits.float() - ref.float()).abs().max().item()
    print(f"entry forward vs impl='naive': max|dlogits|={err:.3e} "
          f"(tol {TOL_LOGITS:.0e}; max|logits|="
          f"{ref.float().abs().max().item():.3e})")
    if err > TOL_LOGITS:
        raise AssertionError("flash and naive ViT-L forwards disagree")
    return fn, model, x, launches["flash_fwd_packed"]


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


def time_flash_fwd(torch, fa):
    """Phase 6: B1 at the ViT-L shape: kernel, plain version, the library
    yardstick and the bound."""
    import torch.nn.functional as F

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
    es = qkv.element_size()
    flops = 4 * b * h * m * (m + 1) * d
    nbytes = b * n * 3 * h * d * es + b * m * h * d * es + b * h * m * 4
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(f"B1 timing at B={b} H={h} N={n} D={d} bf16: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({flops:.3e} FLOP -> {t_ops:.4f} ms; "
          f"{nbytes:.3e} B -> {t_bytes:.4f} ms); "
          f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def time_forward(torch, fn, model, x):
    ms = _elapsed_ms(lambda: fn(model, x), 20)
    n = 1 + x.shape[1] // 3 * (x.shape[2] // 16) ** 2
    dim, depth = model.head.weight.shape[1], len(model.blocks)
    flops = depth * (2 * n * 12 * dim * dim + 4 * n * n * dim) \
        + 2 * (n - 1) * 3 * 16 * 16 * dim
    print(f"entry forward (ViT-L 48x256x256 bf16, batch 1): {ms:.3f} ms per "
          f"volume; {flops:.3e} FLOP -> bound {flops / PEAK_BF16_FLOPS * 1e3:.3f} "
          f"ms at {PEAK_BF16_FLOPS:.3e} FLOP/s")
    return ms


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
    from octcubem_tpu_torch.ops import _cuda
    from octcubem_tpu_torch.ops import flash_attention as fa

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

    t0 = time.time()
    _cuda.build()
    print(f"kernels built in {time.time() - t0:.1f} s")
    for name in _cuda.KERNELS:
        for line in _cuda.build_log(name).read_text().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"ptxas {name}: {line.strip()}")

    err = check_flash_fwd(torch, fa)
    fn, model, x, launches = run_main_path(torch, _cuda, entry_mod)
    run_serve(torch, _cuda, serve)
    timing = time_flash_fwd(torch, fa)
    time_forward(torch, fn, model, x)

    kernels = [{
        "name": "flash_fwd_packed", "route": "cuda",
        "source": "octcubem_tpu_torch/csrc/flash_fwd_packed.cu",
        "replaces": "octcubem_tpu/ops/flash_attention.py:859",
        "launches": launches, "max_abs_err": err, **timing}]
    for k in kernels:
        for key, val in k.items():
            if isinstance(val, float) and not math.isfinite(val):
                raise AssertionError(f"{k['name']}: {key} is {val}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
