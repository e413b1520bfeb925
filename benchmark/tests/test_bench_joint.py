"""The joint pretraining cell (``mae_vitl16_joint``) driven on the CPU at a
cut geometry (2 + 2 blocks, the volume at 48^2 and the 2D images at
64^2 with patch 4, so the blank band's patch rows 3-7 lie inside the
pre-mask's cleared border rows; seeded weights) and computing in
float32: at a few visible tokens a sample bfloat16's rounding is
averaged over too few terms for the card's limits, so the cut run holds
the program's structure to the reference, and the card, at the cell's
own size and precision, its rounding.  The program agrees with
``reference/mae_joint.py`` on the losses, the per-frame losses, the
gradient, the change and the pre-mask; the float8 control, a state left
unchanged and a step without its pre-mask each read not correct; the
new readers read the program's ``premask`` and ``branch2d`` ranges; and
a run loads no JAX."""

from __future__ import annotations

import json

import helpers
import pytest
from test_bench_isolation import FORBIDDEN, _run_py
from test_bench_spans import _give_kernels

import run as bench

CELL = "mae_vitl16_joint"
TINY = dict(depth=2, decoder_depth=2, num_frames=6, pred_t_dim=6,
            input_size=48, high_res_input_size=64, patch_size=4,
            embed_dim=64, num_heads=2, decoder_embed_dim=32,
            decoder_num_heads=2, batch2d=4, compute="float32")
NUMBERS = {"loss_gap", "loss_3d_gap", "loss_2d_gap", "frame_loss_gap",
           "grad_gap", "grad_median_gap", "change_gap", "change_median_gap",
           "premask_gap", "premask_band_gap"}


def _run(seed, trace=False):
    return helpers.tiny_run(CELL, seed=seed, trace=trace, overrides=TINY)


@pytest.fixture(scope="module")
def traced():
    run = _run(3_100_000_019, trace=True)
    return run, helpers.drive(run)


def test_reference_agrees_at_a_cut_geometry(traced):
    run, result = traced
    assert result["correct"], run.checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {n for n, _, _ in run.checks} == NUMBERS | {"failed_steps"}
    assert "setup_s" not in result["metrics"]      # a --trace 1 line
    # the band is found: every followed volume has it forced, both sides
    assert any("whole band forced: program 3 of 3, reference 3 of 3" in n
               for n in run.notes), run.notes


def test_untraced_run_reports_the_end_to_end_metrics():
    run = _run(3_100_000_023)
    result = helpers.drive(run)
    assert result["correct"], run.checks
    assert {"samples_per_s", "setup_s"} <= set(result["metrics"])


def test_control_fails_and_the_program_passes():
    """``calibrate``'s readings: the program within every limit, the
    float8 control beyond one of them, at the cut geometry."""
    run = _run(3_100_000_029)
    readings = {r["reading"]: r for r in
                run.driver.calibrate(run, ["control_fp8"])}
    limits = run.workload["limits"]
    assert all(readings["program"][k] <= v for k, v in limits.items())
    assert any(readings["control_fp8"][k] > v for k, v in limits.items())


def _unchanged(monkeypatch):
    from octcubem_tpu_torch.train import optim

    monkeypatch.setattr(optim.AdamW, "step", lambda self, ok=None: None)


def _no_premask(monkeypatch):
    import torch

    from octcubem_tpu_torch.train import mae_engine

    monkeypatch.setattr(mae_engine, "compute_premask",
                        lambda feat, t, g: torch.zeros(feat.shape[:2]))


@pytest.mark.parametrize("plant", [_unchanged, _no_premask],
                         ids=["state_unchanged", "no_premask"])
def test_fault_reads_not_correct(plant, monkeypatch):
    plant(monkeypatch)
    run = _run(3_100_000_031)
    result = helpers.drive(run)
    assert not result["correct"], run.checks


def test_new_readers_read_the_programs_ranges(traced):
    """With a kernel given to every host op, the pre-mask's and the 2D
    forward's device time read numbers, each a part of the forward's."""
    run, _ = traced
    entries = [m for m in bench.metric_entries(
        bench.load_cell(CELL)[4], CELL, True)
        if m["name"].split(".")[0] in ("premask_device_ms",
                                       "fwd2d_device_ms", "fwd_device_ms")]
    assert len(entries) == 3
    _give_kernels(run.profile.trace)
    got = {k.split(".")[0]: v["value"]
           for k, v in bench.read_metrics(run, entries).items()}
    assert set(got) == {"premask_device_ms", "fwd2d_device_ms",
                        "fwd_device_ms"}
    assert 0 < got["premask_device_ms"] < got["fwd_device_ms"]
    assert 0 < got["fwd2d_device_ms"] < got["fwd_device_ms"]


def test_a_run_loads_no_jax():
    code = (f"import sys; sys.path.insert(0, {str(helpers.HERE / 'tests')!r})\n"
            "import json, helpers\n"
            f"run = helpers.tiny_run({CELL!r}, trace=True, overrides={TINY!r})\n"
            "r = helpers.drive(run)\n"
            "assert r['correct'], run.checks\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = set(json.loads(_run_py(code, helpers.HERE.parent)))
    assert "octcubem_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


@pytest.mark.cuda
def test_control_fails_at_the_cells_size():
    """On the card, at the cell's own size, on three seeds: the program
    reads within every limit and the float8 control fails one of the
    cell's numbers (``tools/calibrate.py``'s readings)."""
    import torch

    bench.set_environment()
    c, config, cfgmod, driver, _ = bench.load_cell(CELL)
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's "
                    "own size")
    from harness.core import Run

    limits = c["limits"]
    for seed in (5_100_000_001, 5_100_000_002, 5_100_000_003):
        run = Run(workload=c, config=config,
                  cfgmod=cfgmod, seed=seed, seconds=0, trace=False,
                  device=torch.device("cuda", 0), cache=bench.CACHE,
                  t_start=0.0)
        readings = {r["reading"]: r for r in
                    driver.calibrate(run, ["control_fp8"])}
        torch.cuda.empty_cache()
        prog, ctrl = readings["program"], readings["control_fp8"]
        assert all(prog[k] <= v for k, v in limits.items()), prog
        assert any(ctrl[k] > v for k, v in limits.items()), ctrl
