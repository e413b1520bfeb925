"""The yardstick's copied counts reproduce their known values, and a
roofline share read from a trace cannot pass 100 % when the kernels run
exactly at their least time."""

from __future__ import annotations

import helpers  # noqa: F401  (puts the benchmark on the path)
import pytest

from harness import readers, work
from harness.core import Run
from harness.profiling import Stretch
from harness.probes import AttentionProbe
from harness.trace import Trace


def test_mae_step_flops_batch4():
    assert 4 * work.mae_train_flops() == pytest.approx(1.248e13, rel=1e-3)


def test_classifier_forward_flops():
    # the released classifier's forward: 48 x 256 x 256, tubes of 3 x 16 x
    # 16, ViT-L/16 over 4,096 tokens and the cls token
    tokens = (48 // 3) * (256 // 16) ** 2
    flops = work.vit_fwd_flops(tokens + 1, 24, 1024, pix=3 * 16 * 16,
                               l=tokens)
    assert flops == pytest.approx(4.131e12, rel=1e-3)


def test_coem_bound_128_pairs_ms():
    ms = work.coem_flops(128) / work.PEAK_BF16_FLOPS * 1e3
    assert ms == pytest.approx(2452.3, abs=0.1)


def test_attention_counts_match_time_kernels():
    # time_kernels.fwd_work(b, h, m, keys, d): 4 b h m keys d FLOP and
    # (2 b h m d + 2 b h keys d) * 2 + 4 b h m bytes, here at n = 5,121
    f, nb = work.attn_fwd_work(1, 16, 5121, 64)
    assert f == 4 * 16 * 5120 * 5121 * 64
    assert nb == (2 * 16 * 5120 * 64 + 2 * 16 * 5121 * 64) * 2 + 16 * 5120 * 4
    fb, _ = work.attn_bwd_work(1, 16, 5121, 64)
    assert fb == 10 * 16 * 5120 * 5121 * 64


def _synthetic(shapes, backward: bool, slack: float = 1.0):
    """A trace in which each attention call launches one kernel that runs
    for ``slack`` times its least time, inside the op's range."""
    events, t = [], 0.0
    name = "bench.attn_bwd" if backward else "bench.attn_fwd"
    fn = work.attn_bwd_work if backward else work.attn_fwd_work
    for i, shape in enumerate(shapes):
        us = work.least_seconds(*fn(*shape)) * 1e6 * slack
        events += [
            {"ph": "X", "cat": "user_annotation", "name": name, "ts": t,
             "dur": 10.0, "tid": 1},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": t + 1.0, "dur": 2.0, "tid": 1, "args": {"correlation": i}},
            {"ph": "X", "cat": "kernel", "name": "k", "ts": t + 5.0,
             "dur": us, "tid": 7, "args": {"correlation": i}},
            # a kernel launched outside the range is not the op's
            {"ph": "X", "cat": "kernel", "name": "other", "ts": t + 6.0 + us,
             "dur": 50.0, "tid": 7, "args": {"correlation": 10_000 + i}},
        ]
        t += 20.0 + us + 60.0
    events.append({"ph": "X", "cat": "user_annotation", "name":
                   "bench.stretch", "ts": 0.0, "dur": t, "tid": 1})
    return Trace(events)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", [(4, 16, 5121, 32), (4, 16, 512, 64),
                                   (1, 16, 4097, 64), (32, 16, 577, 64)])
def test_roofline_at_the_bound_reads_100(shape, backward):
    shapes = [shape] * 3
    att = AttentionProbe()
    (att.bwd if backward else att.fwd).extend(shapes)
    run = Run.__new__(Run)
    run.profile = Stretch(_synthetic(shapes, backward), 1, att)
    share = readers.attn_roofline(run, backward)
    assert share == pytest.approx(100.0, rel=1e-9)
    assert share <= 100.0 + 1e-6


def test_roofline_slower_kernels_read_lower():
    shapes = [(4, 16, 5121, 32)] * 2
    att = AttentionProbe()
    att.fwd.extend(shapes)
    run = Run.__new__(Run)
    run.profile = Stretch(_synthetic(shapes, False, slack=4.0), 1, att)
    assert readers.attn_roofline(run, False) == pytest.approx(25.0)


def test_idle_share_reads_busy_a_step_against_the_window():
    # 3 profiled steps busy 30 us each (the profiler stretches them to
    # 200 us); untraced steps of 100 us
    tr_events = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.stretch",
         "ts": 0.0, "dur": 600.0, "tid": 1}] + [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 200.0 * i,
         "dur": 30.0} for i in range(3)]
    run = Run.__new__(Run)
    run.profile = Stretch(Trace(tr_events), 3)
    run.window = {"seconds": 100e-6 * 50, "steps": 50}
    assert readers.idle_share(run) == pytest.approx(70.0)
    # no device events (the CPU): nothing to read
    run.profile = Stretch(Trace(tr_events[:1]), 3)
    assert readers.idle_share(run) is None


def test_idle_share_is_the_union_of_device_intervals():
    tr = Trace([
        {"ph": "X", "cat": "user_annotation", "name": "bench.stretch",
         "ts": 0.0, "dur": 100.0, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 10.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 20.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 60.0, "dur": 10.0},
    ])
    assert tr.idle_share(0.0, 100.0) == pytest.approx(0.6)
    b = tr.breakdown(0.0, 100.0, 1)
    assert b["idle_gaps"][0][1] == pytest.approx(30e-6)
    assert len(b["device_ops"]) == 3
