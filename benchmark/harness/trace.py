"""Reading a ``torch.profiler`` Chrome trace: device intervals, the host
ranges the harness puts around calls into each layer, and the kernels
each range launched.

A device event (a kernel, a copy or a memset) carries the correlation id
of the runtime call that launched it; that call has a host timestamp and
a thread.  A kernel belongs to a harness range when its launch lies
inside the range on the range's thread.  Attribution goes by the range,
never by a kernel's name, so a later change that swaps the kernels under
a layer is read on the same work.

The idle share is ``chip_smoke.py``'s ``trace_idle_share``: one minus the
union of the device intervals over a window's wall time.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def union(intervals):
    """Sorted, merged copy of (lo, hi) intervals."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1][1] = hi
        else:
            out.append([lo, hi])
    return out


def clip(merged, lo, hi):
    """The merged intervals cut to [lo, hi]."""
    return [[max(a, lo), min(b, hi)] for a, b in merged if b > lo and a < hi]


def covered(merged, lo, hi) -> float:
    """Length of [lo, hi] that the merged intervals cover."""
    return sum(b - a for a, b in clip(merged, lo, hi))


class Trace:
    """The events of one exported trace; times in microseconds."""

    def __init__(self, events):
        self.device = []        # (ts, end, name, correlation)
        self.launch = {}        # correlation -> (ts, tid)
        self.ranges = defaultdict(list)   # annotation name -> [(ts, end, tid)]
        self.ops = defaultdict(list)      # tid -> [(ts, end, name)]
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            ts, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.device.append((ts, end, e.get("name", ""),
                                    args.get("correlation")))
            elif cat in LAUNCH_CATS:
                if args.get("correlation") is not None:
                    self.launch[args["correlation"]] = (ts, e.get("tid"))
            elif cat == "user_annotation":
                self.ranges[e.get("name", "")].append((ts, end, e.get("tid")))
            elif cat == "cpu_op":
                self.ops[e.get("tid")].append((ts, end, e.get("name", "")))
        self.device.sort()
        self.busy = union((a, b) for a, b, _, _ in self.device)
        for v in self.ranges.values():
            v.sort()

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def window(self, name: str) -> tuple[float, float] | None:
        """(first start, last end) of the ranges called ``name``."""
        r = self.ranges.get(name)
        if not r:
            return None
        return r[0][0], max(e for _, e, _ in r)

    def launched_in(self, name: str):
        """The device events whose launch lies inside a range ``name`` on
        the range's thread."""
        by_tid = defaultdict(list)
        for ts, end, tid in self.ranges.get(name, ()):
            by_tid[tid].append((ts, end))
        starts = {t: [a for a, _ in v] for t, v in by_tid.items()}
        out = []
        for ev in self.device:
            hit = self.launch.get(ev[3])
            if hit is None or hit[1] not in by_tid:
                continue
            ts, tid = hit
            rs = by_tid[tid]
            i = bisect.bisect_right(starts[tid], ts) - 1
            # ranges on one thread may nest: look back a few starts
            for j in range(i, max(i - 8, -1), -1):
                if rs[j][0] <= ts <= rs[j][1]:
                    out.append(ev)
                    break
        return out

    def device_seconds_in(self, name: str) -> float:
        """Summed device time of the events launched inside ranges
        ``name`` (s)."""
        return sum(b - a for a, b, _, _ in self.launched_in(name)) / 1e6

    def idle_share(self, lo: float, hi: float) -> float:
        """1 - (union of device intervals within [lo, hi]) / (hi - lo)."""
        return 1.0 - covered(self.busy, lo, hi) / (hi - lo)

    def busy_seconds(self, lo: float, hi: float) -> float:
        return covered(self.busy, lo, hi) / 1e6

    def breakdown(self, lo: float, hi: float, main_tid=None, top: int = 10):
        """{"device_ops": the device operations with the most time in
        [lo, hi], "idle_gaps": the longest gaps between device intervals
        there, each named by the innermost host op running at its middle
        (on ``main_tid`` first), else by the innermost harness range}, in
        seconds as measured."""
        per = defaultdict(float)
        for a, b, name, _ in self.device:
            if b > lo and a < hi:
                per[name] += (min(b, hi) - max(a, lo)) / 1e6
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
        gaps, cur = [], lo
        for a, b in clip(self.busy, lo, hi):
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if hi > cur:
            gaps.append((cur, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        named = [[self._host_at((a + b) / 2, main_tid), (b - a) / 1e6]
                 for a, b in gaps[:top]]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}

    def _host_at(self, t: float, main_tid) -> str:
        def innermost(spans):
            best = None
            for a, b, name in spans:
                if a <= t <= b and (best is None or b - a < best[0]):
                    best = (b - a, name)
            return best[1] if best else None

        tids = ([main_tid] if main_tid in self.ops else []) + [
            k for k in self.ops if k != main_tid]
        for tid in tids:
            name = innermost(self.ops[tid])
            if name:
                return name
        name = innermost([(a, b, n) for n, rs in self.ranges.items()
                          for a, b, _ in rs])
        return name or "host: no op recorded"
