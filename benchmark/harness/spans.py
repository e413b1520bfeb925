"""Readers of the program's own step records and spans
(``octcubem_tpu_torch/utils/profiling.py``): each step of an engine
(``mae``, ``clip``) leaves a record of its phases' host seconds, and while
a profiler records runs in ranges ``octcube.<engine>.<phase>``, its
attention calls in ``octcube.attn.fwd`` / ``octcube.attn.bwd`` with their
shapes in the step's record.  A program without them (a tree from before
they were added) reads None here, and its metrics are left out."""

from __future__ import annotations

import statistics

from .readers import per_step_device_ms
from .work import attn_bwd_work, attn_fwd_work, least_seconds


def _records() -> list:
    try:
        from octcubem_tpu_torch.utils import profiling
    except ImportError:
        return []
    return list(getattr(profiling, "RECORDS", ()))


def window_records(run):
    """The records of the untraced window's steps: the last ``window steps
    + stretch steps`` records less the stretch's, or None where the
    program kept fewer or the split does not fall between an untraced
    step and a profiled one."""
    recs = _records()
    w = run.window.get("steps") or 0
    s = run.profile.steps if run.profile is not None else 0
    if not w or len(recs) < w + s:
        return None
    win, tail = recs[len(recs) - w - s:len(recs) - s], recs[len(recs) - s:]
    if any(r["profiled"] for r in win) or not all(r["profiled"]
                                                  for r in tail):
        return None
    return win


def host_ms(run, phase: str):
    """Median over the window's steps of the host ms in ``phase``."""
    recs = window_records(run)
    if not recs or not any(phase in r["phases"] for r in recs):
        return None
    return statistics.median(r["phases"].get(phase, 0.0)
                             for r in recs) * 1e3


def engine(run):
    """The engine whose ``octcube.<engine>.step`` ranges the profiled
    stretch holds, or None."""
    p = run.profile
    if p is None:
        return None
    names = [n[len("octcube."):-len(".step")] for n in p.trace.ranges
             if n.startswith("octcube.") and n.endswith(".step")]
    return names[0] if len(names) == 1 else None


def device_ms(run, phase: str):
    """Device ms a profiled step of the events launched inside the
    engine's ``phase`` ranges."""
    e = engine(run)
    if e is None:
        return None
    return per_step_device_ms(run, f"octcube.{e}.{phase}")


def attn_roofline(run, backward: bool):
    """Sum of each attention call's least time, from the shapes the
    profiled steps' records hold, over the device time of the events
    launched inside the op's own ``octcube.attn.fwd`` (or ``.bwd``)
    ranges, in %."""
    p = run.profile
    recs = _records()
    if p is None or not p.steps or len(recs) < p.steps:
        return None
    tail = recs[len(recs) - p.steps:]
    if not all(r["profiled"] for r in tail):
        return None
    key = "attn_bwd" if backward else "attn_fwd"
    calls = [tuple(c) for r in tail for c in r.get(key, ())]
    dev = p.trace.device_seconds_in(
        "octcube.attn.bwd" if backward else "octcube.attn.fwd")
    if not calls or dev <= 0:
        return None
    work = attn_bwd_work if backward else attn_fwd_work
    return 100 * sum(least_seconds(*work(*c)) for c in calls) / dev
