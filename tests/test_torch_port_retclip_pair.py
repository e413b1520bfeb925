"""Both packages' cli/retclip.py on the same flags, on the CPU: the
2-tower tiny config through the octcube_ir preset's feature-cached
accumulation (4 chunks of 8) and a tiny 3-modality config, at batch 8:
the JAX CLIs round the batch to a multiple of the 8 CPU devices of the
test mesh.  test_torch_port_retclip_finetune_pair.py does the same for
cli/retclip_finetune.py with these helpers.

The port's models start from the JAX CLI's own init (its flax init at the
same seed, carried over by ``state_dict_from_jax``), and both run in fp32
(a preset file with precision fp32, grad checkpointing on).  Each run
writes to ``--output_dir out`` under its own directory: the same
params.txt byte for byte and the same files; every step's loss (recorded
from the step functions the CLIs build) within TOL_LOSS of JAX's, and
the epoch's retrieval or classification metrics within TOL_METRIC."""

import json
import os

import jax
import numpy as np
import pytest

from octcubem_tpu.cli import retclip as jretclip
from octcubem_tpu.models import coem as jcoem
from octcubem_tpu.train import clip_engine as jeng
from octcubem_tpu_torch.cli import retclip as tretclip
from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.models import coem as tcoem
from octcubem_tpu_torch.train import clip_engine as teng

TOL_LOSS = dict(rtol=1e-5, atol=1e-6)
TOL_METRIC = dict(rtol=1e-5, atol=1e-5)
STEP_FACTORIES = ("make_clip_train_step", "make_clip_accum_train_step",
                  "make_clip_accum_train_step_3mod",
                  "make_clip_cls_train_step")


@pytest.fixture(autouse=True)
def _restore_jax_precision():
    """The JAX CLIs set the global matmul precision; put it back."""
    before = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", before)


def _jax_init(model, generator):
    """The port model given the JAX CLI's init: the flax init of the same
    model at the generator's seed."""
    name = type(model).__name__
    kw = dict(embed_dim=model.embed_dim, vision_cfg=model.vision_cfg,
              enface_cfg=model.enface_cfg)
    if "Classification" in name:
        kw["num_classes"] = model.classification_head.fc2.out_features
    jm = getattr(jcoem, name)(**kw, attn_impl="naive")
    v, e = model.vision_cfg, model.enface_cfg
    vis = np.zeros((1, v["num_frames"], v["img_size"], v["img_size"], 1),
                   np.float32)
    enf = np.zeros((1, e["img_size"], e["img_size"], 3), np.float32)
    args = (vis, enf, enf) if "3Tower" in name else (vis, enf)
    params = jax.jit(jm.init)(jax.random.key(generator.initial_seed()),
                              *args)
    model.load_state_dict(state_dict_from_jax(params), strict=True)


def _recording(monkeypatch, engine, sink):
    """Wrap the engine's step factories so each step's metrics land in
    ``sink`` as (loss, grad_norm) floats."""
    for name in STEP_FACTORIES:
        factory = getattr(engine, name)

        def make(*a, _factory=factory, **k):
            step = _factory(*a, **k)

            def recorded(state, *batch):
                state, m = step(state, *batch)
                sink.append((float(m["loss"]), float(m["grad_norm"])))
                return state, m

            return recorded

        monkeypatch.setattr(engine, name, make)


def _three_mod_config(path):
    path.write_text(json.dumps({
        "embed_dim": 16, "three_mod": True,
        "vision_cfg": {"num_frames": 6, "t_patch_size": 3, "img_size": 32,
                       "patch_size": 16, "in_chans": 1, "embed_dim": 32,
                       "depth": 2, "num_heads": 2},
        "enface_cfg": {"img_size": 32, "patch_size": 16, "in_chans": 3,
                       "embed_dim": 32, "depth": 2, "num_heads": 2,
                       "num_mod_head": 2}}))
    return str(path)


def run_both(root, flags, mains):
    """Run the JAX CLI ``mains[0]`` and the port's ``mains[1]`` on
    ``flags`` with ``--output_dir out`` under root/jax and root/port, the
    port from the JAX init -> ({"jax", "port"}: recorded step metrics,
    the two output dirs)."""
    mp = pytest.MonkeyPatch()
    cwd = os.getcwd()
    losses = {"jax": [], "port": []}
    try:
        _recording(mp, jeng, losses["jax"])
        _recording(mp, teng, losses["port"])
        mp.setattr(tcoem, "init_params", _jax_init)
        for name, main, extra in (("jax", mains[0], []),
                                  ("port", mains[1], ["--device", "cpu"])):
            (root / name).mkdir()
            os.chdir(root / name)
            main(flags + ["--output_dir", "out"] + extra)
    finally:
        os.chdir(cwd)
        mp.undo()
    return losses, root / "jax" / "out", root / "port" / "out"


@pytest.fixture(scope="module", params=["two_tower", "three_mod"])
def runs(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    preset = root / "fp32.json"
    preset.write_text(json.dumps({"precision": "fp32"}))
    config = ("vitl16_octcube_ir_tiny_test" if request.param == "two_tower"
              else _three_mod_config(root / "coem3.json"))
    flags = ["--preset", str(preset), "--model_config", config,
             "--synthetic", "--synthetic_n", "40", "--batch_size", "8",
             "--epochs", "1"]
    return run_both(root, flags, (jretclip.main, tretclip.main))


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_same_files(runs):
    _, jout, tout = runs
    assert sorted(os.listdir(jout)) == sorted(os.listdir(tout))
    assert ((jout / "params.txt").read_text()
            == (tout / "params.txt").read_text())
    assert sorted(os.listdir(jout / "ckpt")) == sorted(
        os.listdir(tout / "ckpt"))


def check_losses(losses):
    assert len(losses["port"]) == len(losses["jax"]) > 0
    (jl, jg), (tl, tg) = losses["jax"][0], losses["port"][0]
    np.testing.assert_allclose(tl, jl, **TOL_LOSS)
    np.testing.assert_allclose(tg, jg, **TOL_LOSS)
    np.testing.assert_allclose([l for l, _ in losses["port"]],
                               [l for l, _ in losses["jax"]], **TOL_LOSS)


def test_losses_match_jax(runs):
    check_losses(runs[0])


def check_metrics(jout, tout):
    jrows, trows = _jsonl(jout / "results.jsonl"), _jsonl(tout / "results.jsonl")
    assert len(jrows) == len(trows) > 0
    for jr, tr in zip(jrows, trows):
        assert jr.keys() == tr.keys()
        for k in jr:
            np.testing.assert_allclose(tr[k], jr[k], err_msg=k, **TOL_METRIC)


def test_metrics_match_jax(runs):
    check_metrics(*runs[1:])
