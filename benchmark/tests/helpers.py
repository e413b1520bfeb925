"""Driving a cell on the CPU at a cut geometry: the harness's look for a
card is skipped, everything after it runs (the program on the CPU runs
its kernels' plain versions)."""

from __future__ import annotations

import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE.parent), str(HERE)]

import torch  # noqa: E402

import run as bench  # noqa: E402
from harness.core import Run  # noqa: E402

# the cells at a size a CPU test holds: every width cut, every mechanism
# kept (mask 0.9 leaves 3 of 32 tokens; a cls token; the LiT lock)
TINY = {
    "mae_vitl16_pretrain": dict(
        depth=2, decoder_depth=1, num_frames=6, pred_t_dim=6, input_size=64,
        high_res_input_size=128, embed_dim=64, num_heads=2,
        decoder_embed_dim=32, decoder_num_heads=2),
    "coem_ir_contrastive": {
        "vision_cfg": dict(num_frames=6, img_size=32, embed_dim=64, depth=4,
                           num_heads=2),
        "enface_cfg": dict(img_size=32, embed_dim=64, depth=2, num_heads=2),
        "embed_dim": 16, "batch_size": 4, "accum_freq": 2,
        "lock_unlocked_groups": 3},
}


def tiny_run(cell: str, seed: int = 12345, trace: bool = False,
             seconds: float = 1.0, overrides: dict | None = None) -> Run:
    """A ``Run`` of ``cell`` on the CPU at its cut geometry."""
    bench.set_environment()
    c, config, cfgmod, driver, manifest = bench.load_cell(cell)
    run = Run(workload=c, config=config, cfgmod=cfgmod, seed=seed,
              seconds=seconds, trace=trace, device=torch.device("cpu"),
              cache=bench.CACHE, t_start=time.time(),
              overrides=TINY[cell] if overrides is None else overrides)
    run.driver, run.manifest = driver, manifest
    return run


def drive(run) -> dict:
    """The run as ``run.py`` carries it out, after the look for a card."""
    return bench.execute(run, run.driver, run.manifest)
