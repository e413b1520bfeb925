"""The readers of the captured step graph's counters
(``metrics/graph_replay_share.py``, ``metrics/graph_pool_gib.py``) on
step records as the program leaves them: a window whose steps replay is
still split from the profiled stretch, which runs eagerly; a program
whose records carry no ``path`` or ``pool_bytes`` (a tree from before
the graph) reads None."""

from __future__ import annotations

import collections
import types

import helpers  # noqa: F401  (puts the harness on the path)
import pytest

import run as bench
from harness import spans


def _rec(path, profiled=False, **kw):
    return {"engine": "mae", "phases": {path: 0.01}, "profiled": profiled,
            "path": path, "seq": 0, **kw}


def _run(window_steps=4, stretch_steps=2):
    return types.SimpleNamespace(window={"steps": window_steps},
                                 profile=types.SimpleNamespace(
                                     steps=stretch_steps))


def _read(base, run):
    return bench.load_module(bench.HERE / "metrics" / f"{base}.py",
                             f"bench_metric_{base}").read(run)


@pytest.fixture
def records(monkeypatch):
    from octcubem_tpu_torch.utils import profiling

    def use(recs):
        monkeypatch.setattr(profiling, "RECORDS", collections.deque(recs))
    return use


def test_a_replayed_window_splits_from_the_eager_stretch(records):
    setup = [_rec("warmup"), _rec("capture", pool_bytes=3 * 2 ** 30),
             _rec("replay")]
    window = [_rec("replay") for _ in range(4)]
    stretch = [_rec("eager", profiled=True) for _ in range(2)]
    records(setup + window + stretch)
    run = _run()
    assert spans.window_records(run) == window
    assert _read("graph_replay_share", run) == 100.0
    assert _read("graph_pool_gib", run) == 3.0
    assert spans.host_ms(run, "forward") is None
    assert spans.host_ms(run, "replay") == pytest.approx(10.0)


def test_the_share_counts_the_window_only(records):
    window = [_rec("replay"), _rec("eager"), _rec("replay"), _rec("replay")]
    records([_rec("warmup")] + window
            + [_rec("eager", profiled=True) for _ in range(2)])
    assert _read("graph_replay_share", _run()) == 75.0
    assert _read("graph_pool_gib", _run()) is None


def test_records_without_the_counters_read_none(records):
    recs = [_rec("eager") for _ in range(4)] + [
        _rec("eager", profiled=True) for _ in range(2)]
    for r in recs:
        del r["path"]
    records(recs)
    assert spans.window_records(_run()) == recs[:4]
    assert _read("graph_replay_share", _run()) is None
    assert _read("graph_pool_gib", _run()) is None
