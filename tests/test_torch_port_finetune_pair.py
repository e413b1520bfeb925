"""One run of each package's fine-tune CLI on the same flags, on the CPU:
``--tiny --synthetic`` and ``--tiny --variable_joint --k_folds 2`` on a
PNG patient tree (alternating low / high-res train streams, the high-res
stream evaluated).  Both write to ``--output_dir out`` under their own
working directory: the same args.json byte for byte, the same files
(metric CSVs, confusion images, logs, checkpoints at the best epoch), the
same CSV columns and row counts and the same log.txt keys."""

import csv
import json
import os

import numpy as np
import pytest

from octcubem_tpu.cli import finetune as jfinetune
from octcubem_tpu_torch.cli import finetune as tfinetune


def _png_tree(root, n=20, size=48):
    from PIL import Image

    rng = np.random.default_rng(0)
    for p in range(n):
        d = root / f"p{p:02d}" / "v0"
        d.mkdir(parents=True)
        for t in range(6):
            arr = (rng.random((size, size)) * 255).astype(np.uint8)
            Image.fromarray(arr, "L").save(str(d / f"oct_{t:03d}.png"))
    return root


@pytest.fixture(scope="module", params=["synthetic", "variable_joint"])
def runs(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"ft_{request.param}")
    if request.param == "synthetic":
        flags = ["--synthetic", "--tiny", "--epochs", "1", "--batch_size",
                 "8", "--synthetic_n", "20"]
    else:
        tree = _png_tree(root / "data")
        flags = ["--tiny", "--variable_joint", "--k_folds", "2", "--epochs",
                 "2", "--batch_size", "8", "--data_dir", str(tree)]
    cwd = os.getcwd()
    results = {}
    try:
        for name, main, extra in (("jax", jfinetune.main, []),
                                  ("port", tfinetune.main,
                                   ["--device", "cpu"])):
            (root / name).mkdir()
            os.chdir(root / name)
            results[name] = main(flags + ["--output_dir", "out"] + extra)
    finally:
        os.chdir(cwd)
    return request.param, results, root / "jax" / "out", root / "port" / "out"


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_args_json_and_files_equal(runs):
    kind, results, jout, tout = runs
    assert (jout / "args.json").read_text() == (tout / "args.json").read_text()
    assert len(results["port"]) == len(results["jax"]) == (
        2 if kind == "variable_joint" else 1)
    jfiles = sorted(os.listdir(jout))
    assert jfiles == sorted(os.listdir(tout))
    tag = "_fold1" if kind == "variable_joint" else ""
    assert {f"macro_metrics_val{tag}.csv", f"macro_metrics_test{tag}.csv",
            f"log{tag}.txt"} <= set(jfiles)
    assert any(f.startswith("confusion_test") for f in jfiles)
    for d in jfiles:
        if d.startswith("ckpt"):
            # one checkpoint kept, at the best epoch
            assert len(os.listdir(tout / d)) == 1


def test_csv_columns_and_rows_equal(runs):
    _, _, jout, tout = runs
    for f in sorted(os.listdir(jout)):
        if f.endswith(".csv"):
            a, b = _rows(jout / f), _rows(tout / f)
            assert a[0] == b[0], f
            assert len(a) == len(b) == 2, f


def test_log_records_have_the_same_keys(runs):
    _, _, jout, tout = runs
    for f in sorted(os.listdir(jout)):
        if f.startswith("log") and f.endswith(".txt"):
            recs = []
            for out in (jout, tout):
                with open(out / f) as fh:
                    recs.append([json.loads(line) for line in fh])
            assert [sorted(r) for r in recs[0]] == [sorted(r)
                                                    for r in recs[1]]
            assert [r["nan_steps"] for r in recs[1]] == [0] * len(recs[1])
