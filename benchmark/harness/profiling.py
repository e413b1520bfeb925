"""The profiled stretch of a ``--trace 1`` run: a short stretch after the
measured window, under ``torch.profiler`` (CPU and CUDA activity), its
Chrome trace written under the checkout's cache, read, and deleted."""

from __future__ import annotations

import os

from .trace import Trace

STRETCH = "bench.stretch"


class Stretch:
    """A parsed profiled stretch: the trace, its window [lo, hi] in
    microseconds (the ``bench.stretch`` range, which ends after a
    synchronize), the main thread, and what the probes counted."""

    def __init__(self, trace: Trace, steps: int, attention=None):
        self.trace = trace
        self.steps = steps
        self.attention = attention
        lo_hi = trace.window(STRETCH)
        self.lo, self.hi = lo_hi if lo_hi else (0.0, 0.0)
        r = trace.ranges.get(STRETCH)
        self.main_tid = r[0][2] if r else None

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return self.trace.busy_seconds(self.lo, self.hi)

    def breakdown(self) -> dict:
        return self.trace.breakdown(self.lo, self.hi, self.main_tid)


def profiled(run, body) -> Trace:
    """Run ``body()`` inside a ``bench.stretch`` range under the profiler,
    synchronising before the range closes -> the parsed trace."""
    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = run.cache / "trace"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{run.name}.{os.getpid()}.json"
    with profile(activities=acts) as prof:
        with record_function(STRETCH):
            body()
            if run.device.type == "cuda":
                torch.cuda.synchronize()
    try:
        prof.export_chrome_trace(str(path))
        return Trace.load(path)
    finally:
        path.unlink(missing_ok=True)
