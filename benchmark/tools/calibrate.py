"""Readings that a cell's limits are set from, on the card at
the cell's own size, in one process:

    python3 benchmark/tools/calibrate.py --workload <cell> --seeds 1 2 ...
        [--faults 3] [--controls control_fp8 fault_half_batch]

For each seed, the cell's driver (its ``calibrate``) gives the program's
numbers against the plain reference (the lower readings) and, for the
first ``--faults`` seeds, those of the readings named by ``--controls``
(the upper readings).  One JSON line per seed and reading; nothing is
timed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import run as bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--controls", nargs="*",
                    default=["control_fp8", "fault_half_batch"])
    args = ap.parse_args(argv)
    bench.set_environment()
    cell, config, cfgmod, driver, _ = bench.load_cell(args.workload)

    import torch

    from harness.core import Run

    for k, seed in enumerate(args.seeds):
        t0 = time.time()
        run = Run(workload=cell, config=config, cfgmod=cfgmod, seed=seed,
                  seconds=0, trace=False, device=torch.device("cuda", 0),
                  cache=bench.CACHE, t_start=t0)
        controls = args.controls if k < args.faults else ()
        for reading in driver.calibrate(run, controls):
            print(json.dumps({"seed": seed, **reading}), flush=True)
        torch.cuda.empty_cache()
        print(f"seed {seed}: {time.time() - t0:.1f} s", file=sys.stderr,
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
