"""What one run of one cell carries from its driver to the metric readers
and the result line: the cell's files, the seed, the window's record,
the spans, the profiled stretch and the comparisons that decide
``correct``."""

from __future__ import annotations

import hashlib
import math
import statistics
import time
from pathlib import Path


def sub_seed(seed: int, tag: str) -> int:
    """A seed for one use (weights, data, noise, arrivals) drawn from the
    run's ``--seed`` and the use's name; any whole number is taken."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


class Run:
    def __init__(self, *, workload: dict, config: dict, cfgmod, seed: int,
                 seconds: float, trace: bool, device, cache: Path,
                 t_start: float, overrides: dict | None = None):
        self.workload = workload
        self.name = workload["name"]
        self.traffic = workload["traffic"]
        self.chips = int(workload["chips"])
        self.config = config
        self.cfgmod = cfgmod
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.cache = Path(cache)
        self.t_start = t_start
        # test-only changes to the configuration (a cut depth on the CPU)
        self.overrides = overrides or {}
        self.setup_s = None
        self.attempted = 0
        self.failed = 0
        self.peak_bytes = 0
        self.window: dict = {}
        self.spans: dict = {}
        self.checks: list = []      # (name, value, limit)
        self.notes: list = []       # earlier lines on standard error
        self.profile = None         # harness.profiling.Stretch of a --trace 1 run

    def seed_for(self, tag: str) -> int:
        return sub_seed(self.seed, tag)

    def setup_done(self) -> None:
        self.setup_s = time.time() - self.t_start

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append((name, float(value), float(limit)))

    def note(self, text: str) -> None:
        self.notes.append(text)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.checks)


def median(xs):
    return statistics.median(xs) if xs else None


def worst_leaf_gap(prog: dict, ref: dict):
    """The largest gap between a leaf's norm on the two sides, over
    ``max(the reference's norm of that leaf, the median leaf's)`` ->
    (gap, leaf)."""
    med = statistics.median(ref.values())
    worst, at = 0.0, None
    for n in ref:
        den = max(ref[n], med)
        gap = abs(prog[n] - ref[n]) / den if den > 0 else (
            0.0 if prog[n] == ref[n] else math.inf)
        if not math.isfinite(prog[n]):
            gap = math.inf
        if gap > worst or at is None:
            worst, at = gap, n
    return worst, at


def train_gaps(prog: dict, ref: dict) -> dict:
    """The numbers a training cell may compare, each side given as
    {"losses": [...], "grad": {leaf: norm of the first gradient},
    "change": {leaf: norm of the change after the followed steps}}:
    loss_gap (the largest relative gap of a step's loss); grad_gap and
    change_gap (the worst leaf, ``worst_leaf_gap``); grad_median_gap and
    change_median_gap (the median leaf's gap, over the same
    denominators).  The change's leaves are the reference's."""
    steps = min(len(prog["losses"]), len(ref["losses"]))
    loss_gap = max(abs(prog["losses"][i] - ref["losses"][i])
                   / abs(ref["losses"][i]) if math.isfinite(prog["losses"][i])
                   else math.inf for i in range(steps))
    grad_gap, grad_leaf = worst_leaf_gap(prog["grad"], ref["grad"])
    gmed = statistics.median(ref["grad"].values())
    grad_median_gap = statistics.median(
        abs(prog["grad"][n] - ref["grad"][n]) / max(ref["grad"][n], gmed)
        for n in ref["grad"])
    change_gap, change_leaf = worst_leaf_gap(prog["change"], ref["change"])
    med = statistics.median(ref["change"].values())
    change_median_gap = statistics.median(
        abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n], med)
        for n in ref["change"])
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "grad_median_gap": grad_median_gap,
            "grad_leaf": grad_leaf, "change_gap": change_gap,
            "change_median_gap": change_median_gap,
            "change_leaf": change_leaf}
