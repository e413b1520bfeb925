"""One run of each package's pretraining CLI on the same flags
(``--synthetic --tiny``, two epochs of one step), on the CPU: the same
args.json byte for byte, the same log.txt keys, the same SPL pickle names
and key sets, and the same checkpoint epochs.  Both write to
``--output_dir out`` under their own working directory, so even the
recorded output_dir agrees."""

import json
import os
import pickle

import pytest

from octcubem_tpu.cli import pretrain as jpretrain
from octcubem_tpu_torch.cli import pretrain as tpretrain

FLAGS = ["--synthetic", "--tiny", "--epochs", "2", "--batch_size", "8",
         "--steps_per_epoch", "1", "--output_dir", "out"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pair")
    cwd = os.getcwd()
    cache = os.environ.get("OCTCUBEM_CACHE_DIR")
    os.environ["OCTCUBEM_CACHE_DIR"] = ""  # no persistent XLA cache
    try:
        for name, main, extra in (("jax", jpretrain.main, []),
                                  ("port", tpretrain.main,
                                   ["--device", "cpu"])):
            (root / name).mkdir()
            os.chdir(root / name)
            main(FLAGS + extra)
    finally:
        os.chdir(cwd)
        if cache is None:
            os.environ.pop("OCTCUBEM_CACHE_DIR")
        else:
            os.environ["OCTCUBEM_CACHE_DIR"] = cache
    return root / "jax" / "out", root / "port" / "out"


def test_args_json_equal(runs):
    jax_out, port_out = runs
    assert ((jax_out / "args.json").read_text()
            == (port_out / "args.json").read_text())


def test_log_keys_equal(runs):
    recs = []
    for out in runs:
        with open(out / "log.txt") as f:
            recs.append([json.loads(line) for line in f])
    assert [sorted(r) for r in recs[0]] == [sorted(r) for r in recs[1]]
    assert [r["epoch"] for r in recs[1]] == [0, 1]
    for a, b in zip(*recs):
        assert (a["spl_k"], a["mask_ratio_2d"]) == (b["spl_k"],
                                                    b["mask_ratio_2d"])


def test_spl_pickles_equal_in_names_and_keys(runs):
    names = [sorted(f for f in os.listdir(out) if f.endswith(".pkl"))
             for out in runs]
    assert names[0] == names[1] == ["all_image_dict-0.pkl",
                                    "all_image_dict-1.pkl"]
    for f in names[0]:
        dicts = []
        for out in runs:
            with open(out / f, "rb") as fh:
                dicts.append(pickle.load(fh))
        assert set(dicts[0]) == set(dicts[1])
        assert all(set(dicts[0][k]) == set(dicts[1][k]) for k in dicts[0])


def test_checkpoint_epochs_equal(runs):
    steps = [sorted(n for n in os.listdir(out / "ckpt") if n.isdigit())
             for out in runs]
    assert steps[0] == steps[1] == ["0", "1"]
