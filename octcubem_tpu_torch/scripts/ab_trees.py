"""A/B of two checkouts on the card: the ViT-L/16 MAE step (both decoder
geometries) and the ViT-L/16 serving forward, each tree in its own
process, in the order parent, change, change, parent.

    python octcubem_tpu_torch/scripts/ab_trees.py --parent build/parent \\
        [--change .]

``--parent`` is a tree unpacked with ``git archive`` under a directory
the repo ignores (``build/``); ``--change`` defaults to this checkout.
Each process builds its tree's kernels, then times ``train_entry()``'s
step (batch 4, mask 0.90; 10 steps after 2) and ``entry()``'s forward
(20 after 2) with CUDA events, and prints one JSON line; the card's name
and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from octcubem_tpu_torch import entry
from octcubem_tpu_torch.ops import _cuda

_cuda.build()
torch.backends.cuda.matmul.allow_tf32 = False


def ms(fn, iters, warm=2):
    for _ in range(warm):
        fn()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


out = {}
for dec in (16, 4):
    step, state, x = entry.train_entry(dec_heads=dec, batch=4)
    box = [state]

    def one():
        box[0], _ = step(box[0], x, mask_ratio=0.9)

    out[f"mae_step_dec{dec}_ms"] = ms(one, 10)
    del step, state, x, box
    torch.cuda.empty_cache()
fn, (model, x) = entry.entry()
out["vitl_forward_ms"] = ms(lambda: fn(model, x), 20)
print(json.dumps(out))
'''


def run(root: Path) -> dict:
    r = subprocess.run([sys.executable, "-c", CHILD, str(root)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{root}: {r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    here = Path(__file__).resolve().parents[2]
    parser = argparse.ArgumentParser(__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True)
    parser.add_argument("--change", default=str(here))
    args = parser.parse_args(argv)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    for label in ("parent", "change", "change", "parent"):
        root = Path(getattr(args, label)).resolve()
        print(label, json.dumps(run(root)), flush=True)


if __name__ == "__main__":
    main()
