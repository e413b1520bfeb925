"""Both packages' cli/retclip_finetune.py on the same flags, on the CPU:
--tiny synthetic, 2-tower and 3-modality, two folds of one epoch at batch
8 (the JAX CLI rounds the batch to a multiple of the 8 CPU devices of the
test mesh), the port from the JAX CLI's own init and in fp32 as the JAX
CLI runs: the same files, every step's loss within TOL_LOSS of JAX's, the
per-fold val AUC and accuracy within TOL_METRIC
(test_torch_port_retclip_pair.py's helpers)."""

import json
import os

import jax
import pytest

from octcubem_tpu.cli import retclip_finetune as jfinetune
from octcubem_tpu_torch.cli import retclip_finetune as tfinetune
from tests.test_torch_port_retclip_pair import (check_losses, check_metrics,
                                                run_both)


@pytest.fixture(autouse=True)
def _restore_jax_precision():
    """The JAX CLIs set the global matmul precision; put it back."""
    before = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", before)


@pytest.fixture(scope="module", params=["two_tower", "three_mod"])
def runs(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    flags = ["--tiny", "--epochs", "1", "--batch_size", "8",
             "--synthetic_n", "32"]
    if request.param == "three_mod":
        flags.append("--three_mod")
    return run_both(root, flags, (jfinetune.main, tfinetune.main))


def test_same_files(runs):
    _, jout, tout = runs
    assert sorted(os.listdir(jout)) == sorted(os.listdir(tout))
    with open(jout / "cv_registry.json") as a, \
            open(tout / "cv_registry.json") as b:
        assert json.load(a).keys() == json.load(b).keys()


def test_losses_match_jax(runs):
    check_losses(runs[0])


def test_metrics_match_jax(runs):
    check_metrics(*runs[1:])
