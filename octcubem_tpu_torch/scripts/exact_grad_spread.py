"""How far B6 + B7's gradients at large logits land from the plain
versions' across seeds, on the card: each configuration below (the
large-logit cases of chip_smoke.py's phase 10 and of the card tests) is
drawn from seeds 0 .. --seeds - 1, and for each draw the worst of dq, dk,
dv is printed as a share of the bf16 gradient limit (TOL_GRAD, 2^-7 of
max|plain|) for

- chain: the tree's B6 forward, then B7, under autograd, against the plain
  backward on the plain forward's (o, lse) (chip_smoke.py's check);
- b7: the same gradients against the plain backward on the kernel's own
  (o, lse);
- forwards: the plain backward on the kernel's (o, lse) against the plain
  backward on the plain forward's, i.e. what o's and lse's differences
  alone move.

    python octcubem_tpu_torch/scripts/exact_grad_spread.py [--root DIR]
        [--seeds 12]

``--root`` takes the package of another tree (e.g. a parent unpacked
under build/), so two forward bodies compare on the same draws; run the
script as a file.  Prints one line per configuration and measure, then
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

# name -> (B, Nq, Nk, kv_valid, H, D, q and k multipliers, fused views)
CONFIGS = {
    "rect D=64 q, k x 8 (chip_smoke)": (2, 200, 700, 650, 4, 64, 8.0, 8.0,
                                        False),
    "square D=80 q, k x 8 n=1025 (chip_smoke)": (2, 1025, 1025, None, 4, 80,
                                                 8.0, 8.0, True),
    "square D=80 q, k x 8 n=333 (card test)": (2, 333, 333, None, 2, 80, 8.0,
                                               8.0, True),
    "square D=32 q x 40 n=1025": (2, 1025, 1025, None, 4, 32, 40.0, 1.0,
                                  True),
}


def _share(torch, got, ref) -> float:
    """max over dq, dk, dv of max|got - ref| / max|ref|, over 2^-7."""
    return max(((a.float() - r.float()).abs().max()
                / r.float().abs().max()).item() * 128
               for a, r in zip(got[:3], ref[:3]))


def draw(torch, fa, seed, b, nq, nk, kv, h, d, qm, km, views):
    """(chain, b7, forwards) shares of TOL_GRAD for one draw."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtype, scale = torch.bfloat16, d ** -0.5
    if views:
        x = torch.randn((b, nq, 3 * h * d), generator=gen, device="cuda")
        x[..., :h * d] *= qm
        x[..., h * d:2 * h * d] *= km
        q, k, v = (x.to(dtype)[..., i * h * d:(i + 1) * h * d]
                   .view(b, nq, h, d).transpose(1, 2) for i in range(3))
    else:
        q = (qm * torch.randn((b, h, nq, d), generator=gen,
                              device="cuda")).to(dtype)
        k = (km * torch.randn((b, h, nk, d), generator=gen,
                              device="cuda")).to(dtype)
        v = torch.randn((b, h, nk, d), generator=gen, device="cuda").to(dtype)
    o, lse = fa.fwd_bh_cuda(q, k, v, None, None, scale, kv, False)
    o_ref, lse_ref = fa.fwd_bh_exact_plain(q, k, v, scale, kv)
    g = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(
        fa.flash_attention_rect(*ts, scale, False, kv), ts, g)
    ref = fa.bwd_bh_plain(q, k, v, None, None, o_ref, lse_ref, g, None, scale,
                          False, kv)
    own = fa.bwd_bh_plain(q, k, v, None, None, o, lse, g, None, scale, False,
                          kv)
    return (_share(torch, grads, ref), _share(torch, grads, own),
            _share(torch, own, ref))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[2]))
    parser.add_argument("--seeds", type=int, default=12)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    from octcubem_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("exact_grad_spread: no CUDA device", file=sys.stderr)
        return 2
    for name, cfg in CONFIGS.items():
        rows = [draw(torch, fa, seed, *cfg) for seed in range(args.seeds)]
        for i, what in enumerate(("chain", "b7", "forwards")):
            vals = [r[i] for r in rows]
            print(f"{name} {what}: max {max(vals):.3f}, "
                  f"{sum(v > 1 for v in vals)} of {len(vals)} draws over "
                  "1: " + " ".join(f"{v:.2f}" for v in vals), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
