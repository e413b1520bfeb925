"""Each cell driven on the CPU at a cut geometry: the plain reference
agrees with the program (``correct`` true), and with the timed path
broken underneath ``correct`` comes out false, once for each fault the
cell can have: a step that returns its state unchanged, and half of the
batch left out with the mean taken over the rest.  On the card, at each
cell's own size, the float8 control fails one of the cell's numbers."""

from __future__ import annotations

import helpers
import pytest
import torch

CELLS = ["mae_vitl16_pretrain", "coem_ir_contrastive"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_at_a_cut_geometry(cell):
    run = helpers.tiny_run(cell, seed=3_000_000_017)
    result = helpers.drive(run)
    assert result["correct"], run.checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "setup_s" in result["metrics"]


def test_traced_run_reads_per_layer_metrics():
    run = helpers.tiny_run("mae_vitl16_pretrain", trace=True)
    result = helpers.drive(run)
    assert result["correct"], run.checks
    got = set(result["metrics"])
    # no device on the CPU: the device readers find nothing to read
    assert {"issue_ms.train", "mfu.train"} <= got
    assert run.profile.attention.fwd and run.profile.attention.bwd


def _unchanged(monkeypatch):
    from octcubem_tpu_torch.train import optim

    monkeypatch.setattr(optim.AdamW, "step", lambda self, ok=None: None)


def _half_batch_mae(monkeypatch):
    from octcubem_tpu_torch.train import mae_engine

    make = mae_engine.make_mae_train_step

    def broken(*a, **kw):
        step = make(*a, **kw)

        def half(state, x, mask_ratio=0.9, noise=None, **k):
            n = x.shape[0] // 2
            return step(state, x[:n], mask_ratio, noise=noise[:n], **k)
        return half
    monkeypatch.setattr(mae_engine, "make_mae_train_step", broken)


def _half_batch_clip(monkeypatch):
    from octcubem_tpu_torch.train import clip_engine

    make = clip_engine.make_clip_accum_train_step

    def broken(*a, **kw):
        step = make(*a, **kw)

        def half(state, batch):
            n = batch["image"].shape[1] // 2
            return step(state, {k: v[:, :n] for k, v in batch.items()})
        return half
    monkeypatch.setattr(clip_engine, "make_clip_accum_train_step", broken)


FAULTS = [
    ("mae_vitl16_pretrain", "state_unchanged", _unchanged),
    ("mae_vitl16_pretrain", "half_batch", _half_batch_mae),
    ("coem_ir_contrastive", "state_unchanged", _unchanged),
    ("coem_ir_contrastive", "half_batch", _half_batch_clip),
]


@pytest.mark.parametrize("cell,fault,plant", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_fault_reads_not_correct(cell, fault, plant, monkeypatch):
    plant(monkeypatch)
    run = helpers.tiny_run(cell, seed=3_000_000_023)
    result = helpers.drive(run)
    assert not result["correct"], run.checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    """On the card, at the cell's own size, on three seeds: the program
    reads within every limit and the control fails one of the cell's
    numbers (``tools/calibrate.py``'s readings)."""
    import run as bench

    bench.set_environment()
    c, config, cfgmod, driver, _ = bench.load_cell(cell)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c["chips"]:
        pytest.skip(f"needs {c['chips']} NVIDIA card(s): the control runs "
                    f"at the cell's own size")
    from harness.core import Run

    seeds = (5_000_000_001, 5_000_000_002, 5_000_000_003)
    run = Run(workload=c, config=config, cfgmod=cfgmod, seed=seeds[0],
              seconds=0, trace=False, device=torch.device("cuda", 0),
              cache=bench.CACHE, t_start=0.0)
    got = []
    for seed in seeds:
        run.seed = seed
        got += [(seed, r) for r in driver.calibrate(run, ["control_fp8"])]
        torch.cuda.empty_cache()
    limits = c["limits"]
    for seed in seeds:
        readings = {r["reading"]: r for s, r in got if s == seed}
        prog = readings.pop("program")
        assert all(prog[k] <= v for k, v in limits.items()), prog
        ctrl = readings["control_fp8"]
        assert any(ctrl[k] > v for k, v in limits.items()), ctrl
