"""How far the fine-tune model's flash path (B1 + B2) lands from
impl="naive" under its multi-task loss across seeds, and how far a broken
B1 moves it, on the card.  The model is chip_smoke.py's phase 19b: the
octcube_multitask ViT-L/16 cut to 2 blocks, 48x256x256 (4,097 tokens),
batch 1, drop path 0, fp32 and bf16.  For each draw it prints
|dloss| / |loss| and, over leaves, the worst max|dgrad| / max|grad|.

The draws are phase 19b's own (input seed 21, weights seed 22) and seeds
(100 + s, s) for s in 0 .. --seeds - 1.  Then phase 19b's draw again with
B1 broken at run time (the function the autograd op calls is swapped for
one that changes its arguments; the sources are untouched):

- scale: the softmax scale off by 2^-7 relative (one bf16 step);
- scale_d128: the scale of D = 128, not 64 (2^-0.5 of the right one);
- no_cls: the cls key and value left out of every patch query's softmax.

    python octcubem_tpu_torch/scripts/ft_naive_spread.py [--seeds 6]

Prints one JSON line per draw, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TARGET = [[0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]]


def measure(torch, dtype, x_seed, w_seed):
    """(|dloss| / |loss|, worst leaf's max|dgrad| / max|grad|) of flash
    against impl="naive" on one draw."""
    from octcubem_tpu_torch.models import vit_st
    from octcubem_tpu_torch.train import losses

    gen = torch.Generator(device="cuda").manual_seed(x_seed)
    x = torch.rand((1, 48, 256, 256, 1), generator=gen, device="cuda")
    y = torch.tensor(TARGET, device="cuda")
    crit = losses.make_criterion("multi_task_default")
    model = vit_st.create_model(
        vit_st.vit_large_patch16, seed=w_seed, depth=2, num_frames=48,
        img_size=256, in_chans=1, num_classes=16, dtype=dtype).train()
    mhas = [m for m in model.modules() if hasattr(m, "attn_impl")]
    res = {}
    for impl in ("auto", "naive"):
        for m in mhas:
            m.attn_impl = impl
        model.zero_grad(set_to_none=True)
        loss = crit(model(x), y)
        loss.backward()
        res[impl] = (loss.item(), {n: p.grad.clone() for n, p in
                                   model.named_parameters()
                                   if p.grad is not None})
    (lf, gf), (ln, gn) = res["auto"], res["naive"]
    worst = max((gf[n] - gn[n]).abs().max().item()
                / gn[n].abs().max().item() for n in gn)
    del model, res
    torch.cuda.empty_cache()
    return abs(lf - ln) / abs(ln), worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ft_naive_spread: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from octcubem_tpu_torch.ops import _cuda
    from octcubem_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.build()
    draws = [("phase 19b", 21, 22)] + [(f"seed {s}", 100 + s, s)
                                        for s in range(args.seeds)]
    real = fa.fwd_packed
    broken = {
        "scale": lambda q, k, v, kc, vc, h, scale: real(
            q, k, v, kc, vc, h, scale * (1 + 2 ** -7)),
        "scale_d128": lambda q, k, v, kc, vc, h, scale: real(
            q, k, v, kc, vc, h, scale * 2 ** -0.5),
        "no_cls": lambda q, k, v, kc, vc, h, scale: real(
            q, k, v, None, None, h, scale),
    }
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for what, xs, ws in draws:
            dl, dg = measure(torch, dtype, xs, ws)
            print(json.dumps({"dtype": name, "draw": what, "b1": "kernel",
                              "loss_rel": dl, "grad_rel": dg}), flush=True)
        for kind, fn in broken.items():
            fa.fwd_packed = fn
            try:
                dl, dg = measure(torch, dtype, 21, 22)
            finally:
                fa.fwd_packed = real
            print(json.dumps({"dtype": name, "draw": "phase 19b",
                              "b1": f"broken: {kind}", "loss_rel": dl,
                              "grad_rel": dg}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
