"""Arithmetic the metric readers share.  A reader returns None where its
run has nothing to read (no profiled stretch, no span, no device time),
and the harness then leaves the metric out of the line."""

from __future__ import annotations

from .core import median
from .work import PEAK_BF16_FLOPS, attn_bwd_work, attn_fwd_work, least_seconds


def window_rate(run, key: str):
    w = run.window
    if not w.get(key) or not w.get("seconds"):
        return None
    return w[key] / w["seconds"]


def span_median_ms(run, name: str):
    m = median(run.spans.get(name, []))
    return None if m is None else m * 1e3


def mfu(run):
    """The window's analytic FLOPs over its seconds, a share of the chips'
    bf16 peak, in %."""
    w = run.window
    if not w.get("flops") or not w.get("seconds"):
        return None
    return 100 * w["flops"] / w["seconds"] / (PEAK_BF16_FLOPS * run.chips)


def idle_share(run):
    """1 - the device's busy time a profiled step over the untraced
    window's time a step, in %."""
    p, w = run.profile, run.window
    if p is None or p.hi <= p.lo or not p.steps or not w.get("steps"):
        return None
    busy = p.busy_s / p.steps
    if busy <= 0:
        return None
    return 100 * (1 - busy / (w["seconds"] / w["steps"]))


def per_step_device_ms(run, rng: str):
    p = run.profile
    if p is None or not p.steps:
        return None
    s = p.trace.device_seconds_in(rng)
    return s / p.steps * 1e3 if s > 0 else None


def attn_roofline(run, backward: bool):
    """Sum of each attention call's least time over the device time of the
    kernels launched inside the attention op's forward (or backward)
    ranges, in %."""
    p = run.profile
    if p is None or p.attention is None:
        return None
    calls = p.attention.bwd if backward else p.attention.fwd
    dev = p.trace.device_seconds_in(
        "bench.attn_bwd" if backward else "bench.attn_fwd")
    if not calls or dev <= 0:
        return None
    work = attn_bwd_work if backward else attn_fwd_work
    least = sum(least_seconds(*work(*shape)) for shape in calls)
    return 100 * least / dev
