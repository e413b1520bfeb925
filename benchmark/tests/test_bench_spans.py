"""The readers of the program's own spans (``harness/spans.py``) on a tiny
traced CPU run of each cell: every one reads a number once the trace has
device events (a CPU run has none, so each host op is given a kernel),
the host readers take exactly the window's steps, and a program without
step records or ``octcube.*`` ranges (a tree from before them) reads
None."""

from __future__ import annotations

import collections
import itertools
import statistics

import helpers
import pytest

import run as bench
from harness import spans
from harness.trace import union

BASES = ("fwd_host_ms", "bwd_host_ms", "update_host_ms", "fwd_device_ms",
         "bwd_device_ms", "update_device_ms", "attn_fwd_span_roofline",
         "attn_bwd_span_roofline")
HOST = BASES[:3]
KIND = {"mae_vitl16_pretrain": "train", "coem_ir_contrastive": "clip"}


def _give_kernels(trace) -> None:
    """A 1 us kernel launched at the start of every host op of the trace,
    on the op's thread."""
    ids = itertools.count(10 ** 9)
    for tid, ops in trace.ops.items():
        for ts, _, name in ops:
            c = next(ids)
            trace.launch[c] = (ts, tid)
            trace.device.append((ts + 0.5, ts + 1.5, name, c))
    trace.device.sort()
    trace.busy = union((a, b) for a, b, _, _ in trace.device)


def _entries(cell):
    return [m for m in bench.metric_entries(
        bench.load_cell(cell)[4], cell, True)
        if m["name"].split(".")[0] in BASES]


@pytest.fixture(scope="module", params=list(KIND))
def traced(request):
    cell = request.param
    run = helpers.tiny_run(cell, seed=2_900_000_011, trace=True)
    result = helpers.drive(run)
    from octcubem_tpu_torch.utils import profiling

    return cell, run, result, list(profiling.RECORDS)


def test_the_span_metrics_read_numbers(traced):
    cell, run, result, _ = traced
    kind = KIND[cell]
    assert result["correct"], run.checks
    entries = _entries(cell)
    assert sorted(m["name"] for m in entries) == sorted(
        f"{b}.{kind}" for b in BASES)
    # no device on the CPU: only the host readers read from the run as is
    assert {f"{b}.{kind}" for b in HOST} <= set(result["metrics"])
    _give_kernels(run.profile.trace)
    got = bench.read_metrics(run, entries)
    assert set(got) == {m["name"] for m in entries}
    assert all(v["value"] > 0 for v in got.values())
    # each phase's device time is a part of the stretch's
    total = sum(b - a for a, b, _, _ in run.profile.trace.device) / 1e6
    phases = sum(got[f"{p}_device_ms.{kind}"]["value"]
                 for p in ("fwd", "bwd", "update"))
    assert phases * run.profile.steps / 1e3 <= total


def test_the_host_readers_take_exactly_the_window(traced, monkeypatch):
    cell, run, _, recs = traced
    from octcubem_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "RECORDS", collections.deque(recs))
    w, s = run.window["steps"], run.profile.steps
    win = spans.window_records(run)
    assert len(win) == w and win == recs[-w - s:-s]
    assert not any(r["profiled"] for r in win)
    assert all(r["profiled"] for r in recs[-s:])
    # set-up's followed steps come before the window
    assert len(recs) >= w + s + run.traffic["follow_steps"]
    want = statistics.median(r["phases"]["forward"] for r in win) * 1e3
    assert spans.host_ms(run, "forward") == want
    # a deque that lost the window's first step reads nothing
    monkeypatch.setattr(profiling, "RECORDS",
                        collections.deque(recs[-w - s + 1:]))
    assert spans.host_ms(run, "forward") is None


def test_a_program_without_spans_reads_none(traced, monkeypatch):
    cell, run, _, _ = traced
    from octcubem_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "RECORDS", collections.deque())
    entries = _entries(cell)
    got = bench.read_metrics(run, entries)
    assert not any(n.split(".")[0] in HOST + BASES[6:] for n in got)
    monkeypatch.setattr(run.profile.trace, "ranges", {
        k: v for k, v in run.profile.trace.ranges.items()
        if not k.startswith("octcube.")})
    assert bench.read_metrics(run, entries) == {}
    monkeypatch.delattr(profiling, "RECORDS")
    assert bench.read_metrics(run, entries) == {}
