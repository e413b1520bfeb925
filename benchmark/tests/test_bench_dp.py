"""The data-parallel cell (``mae_vitl16_dp4``) driven on four gloo CPU
ranks at a cut geometry: rank 0 in the test's process, ranks 1-3 started
by the driver, meeting it over a ``TCPStore`` on localhost.  After the
followed steps every rank holds the same params bit for bit and rank 0
agrees with the plain reference's one-rank steps on the global batch of
16; a rank 0 that does not update reads not correct; the all-reduce's
reader reads the program's ``reduce`` ranges; a run loads no JAX, in any
rank."""

from __future__ import annotations

import json

import helpers
import pytest
from test_bench_isolation import FORBIDDEN, _run_py
from test_bench_spans import _give_kernels

import run as bench

CELL = "mae_vitl16_dp4"
TINY = helpers.TINY["mae_vitl16_pretrain"]


@pytest.fixture(scope="module")
def traced():
    run = helpers.tiny_run(CELL, seed=3_200_000_011, trace=True,
                           overrides=TINY)
    return run, helpers.drive(run)


def test_four_ranks_agree_with_the_one_rank_reference(traced):
    run, result = traced
    assert result["correct"], run.checks
    checks = {n: v for n, v, _ in run.checks}
    assert checks["rank_param_mismatch"] == 0
    assert set(checks) == set(run.workload["limits"]) | {
        "failed_steps", "rank_param_mismatch"}
    assert result["attempted"] > 0 and result["failed"] == 0
    # the window counts global volumes: 4 a rank on 4 ranks
    assert run.window["samples"] == 16 * run.window["steps"]
    assert {"issue_ms.dp", "mfu.dp"} <= set(result["metrics"])


def test_the_allreduce_reader_reads_the_reduce_ranges(traced):
    run, _ = traced
    entries = [m for m in bench.metric_entries(
        bench.load_cell(CELL)[4], CELL, True)
        if m["name"].split(".")[0] in ("allreduce_ms", "update_device_ms")]
    _give_kernels(run.profile.trace)
    got = {k.split(".")[0]: v["value"]
           for k, v in bench.read_metrics(run, entries).items()}
    assert 0 < got["allreduce_ms"] < got["update_device_ms"]


def test_a_rank_that_does_not_update_reads_not_correct(monkeypatch):
    """AdamW's step left out on rank 0 alone: its params part from the
    other ranks' and from the reference's."""
    from octcubem_tpu_torch.train import optim

    monkeypatch.setattr(optim.AdamW, "step", lambda self, ok=None: None)
    run = helpers.tiny_run(CELL, seed=3_200_000_013, overrides=TINY)
    result = helpers.drive(run)
    assert not result["correct"], run.checks
    assert {n: v for n, v, _ in run.checks}["rank_param_mismatch"] > 0


def test_a_run_loads_no_jax():
    """Rank 0's modules here; each worker rank checks its own before it
    exits and ends with code 3 if it loaded one, which fails the run."""
    code = (f"import sys; sys.path.insert(0, {str(helpers.HERE / 'tests')!r})\n"
            "import json, helpers\n"
            f"run = helpers.tiny_run({CELL!r}, overrides={TINY!r})\n"
            "r = helpers.drive(run)\n"
            "assert r['correct'], run.checks\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = set(json.loads(_run_py(code, helpers.HERE.parent)))
    assert "octcubem_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
