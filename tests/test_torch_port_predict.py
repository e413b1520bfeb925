"""cli/predict.py through both packages on the same flags and the same
checkpoint (a JAX-exported .pth), on the CPU: patient trees of .npy, PNG
and DICOM volumes (3 volumes at batch 2, so the tail batch is padded),
the CSV's columns, rows and probabilities and the embeddings .npz; int8
against JAX's int8; the AOT artifact against the live CSV; --n_data
above 1 refused."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from octcubem_tpu.cli import predict as jpredict
from octcubem_tpu.compat import torch_export as jexport
from octcubem_tpu.models import vit_st as jvst
from octcubem_tpu_torch.cli import predict as tpredict
from octcubem_tpu_torch.data.dicom import write_dicom

FLAGS = ["--batch_size", "2", "--num_frames", "6", "--input_size", "32",
         "--nb_classes", "4", "--embed_dim", "64", "--depth", "2",
         "--num_heads", "2"]
# the CSV's 4-decimal probabilities: one rounding step, plus the model's
# fp32 tolerance
TOL_CSV = 1.5e-4
# int8: the block projections quantize activations per token; a value on
# a rounding edge can land one int8 step apart (test_torch_port_quant.py's
# bound on logits, 1e-3, is the same one on probabilities here)
TOL_INT8 = 1e-3


@pytest.fixture(autouse=True)
def _restore_jax_precision():
    """The JAX CLI sets the global matmul precision; put it back."""
    before = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", before)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A random ViT (embed 64, 2 heads of 32, depth 2) exported by JAX."""
    jm = jvst.VisionTransformerST(
        num_frames=6, t_patch_size=3, img_size=32, in_chans=1, num_classes=4,
        embed_dim=64, depth=2, num_heads=2, head_type="dropout",
        attn_impl="naive")
    params = jax.jit(jm.init)(jax.random.key(3), jnp.zeros((1, 6, 32, 32, 1)))
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.05 *
                          rng.standard_normal(a.shape).astype(np.float32),
                          params)
    path = str(tmp_path_factory.mktemp("ckpt") / "m.pth")
    jexport.save_torch_checkpoint(path, jexport.export_state_dict(params))
    return path


def _tree(root, fmt):
    rng = np.random.default_rng(5)
    for p in range(3):
        vol = (rng.random((6, 40, 40)) * 255).astype(np.uint8)
        d = root / f"p{p}" / "v0"
        d.mkdir(parents=True)
        if fmt == "npy":
            np.save(d / "vol.npy", vol.astype(np.float32))
        elif fmt == "dcm":
            write_dicom(str(d / "vol.dcm"), vol)
        else:
            from PIL import Image

            for t in range(6):
                Image.fromarray(vol[t], "L").save(str(d / f"oct_{t:03d}.png"))
    return root


def _run(main, tree, out, extra):
    rows = main([str(tree), "--out_csv", str(out / "p.csv"),
                 "--dump_embeddings", str(out / "e.npz")] + FLAGS + extra)
    with open(out / "p.csv") as f:
        table = list(csv.reader(f))
    return rows, table, np.load(out / "e.npz")


def _probs(table):
    return np.array([[float(v) for v in r[1:]] for r in table[1:]])


@pytest.mark.parametrize("fmt", ["npy", "png", "dcm"])
def test_predict_matches_jax(fmt, ckpt, tmp_path):
    tree = _tree(tmp_path / "data", fmt)
    outs = {}
    for name, main, extra in (
            ("jax", jpredict.main, []),
            ("port", tpredict.main, ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        outs[name] = _run(main, tree, tmp_path / name,
                          ["--ckpt", ckpt, "--precision", "fp32"] + extra)
    (jrows, jtab, jemb), (trows, ttab, temb) = outs["jax"], outs["port"]
    assert ttab[0] == jtab[0] == ["patient_id", "class_0", "class_1"]
    assert [r[0] for r in ttab] == [r[0] for r in jtab]
    assert len(trows) == len(jrows) == 3
    np.testing.assert_allclose(_probs(ttab), _probs(jtab), atol=TOL_CSV)
    assert temb["embeddings"].shape == jemb["embeddings"].shape == (3, 64)
    np.testing.assert_allclose(temb["embeddings"], jemb["embeddings"],
                               atol=5e-5, rtol=5e-5)
    assert list(temb["patient_ids"]) == list(jemb["patient_ids"])


def test_predict_int8_matches_jax_int8(ckpt, tmp_path):
    tree = _tree(tmp_path / "data", "npy")
    tabs = []
    for name, main, extra in (("jax", jpredict.main, []),
                              ("port", tpredict.main, ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        tabs.append(_run(main, tree, tmp_path / name,
                         ["--ckpt", ckpt, "--quant", "int8",
                          "--precision", "fp32"] + extra)[1])
    assert tabs[0][0] == tabs[1][0] and len(tabs[0]) == len(tabs[1]) == 4
    np.testing.assert_allclose(_probs(tabs[1]), _probs(tabs[0]),
                               atol=TOL_INT8)


def test_aot_artifact_gives_the_live_csv(ckpt, tmp_path):
    """--export_aot writes the (logits, embedding) forward; --aot on it
    takes its shapes from the header and gives the live CSV, embeddings to
    1e-6."""
    tree = _tree(tmp_path / "data", "npy")
    (tmp_path / "live").mkdir()
    _, live, lemb = _run(tpredict.main, tree, tmp_path / "live",
                         ["--ckpt", ckpt, "--device", "cpu"])
    art = str(tmp_path / "m.octaot")
    assert tpredict.main([str(tree), "--ckpt", ckpt, "--device", "cpu",
                          "--export_aot", art] + FLAGS) == art
    (tmp_path / "aot").mkdir()
    rows = tpredict.main([str(tree), "--aot", art, "--device", "cpu",
                          "--out_csv", str(tmp_path / "aot" / "p.csv"),
                          "--dump_embeddings", str(tmp_path / "aot" / "e.npz")])
    with open(tmp_path / "aot" / "p.csv") as f:
        assert list(csv.reader(f)) == live
    assert len(rows) == 3
    np.testing.assert_allclose(np.load(tmp_path / "aot" / "e.npz")[
        "embeddings"], lemb["embeddings"], atol=1e-6, rtol=0)


def test_predict_refuses_data_parallel_and_empty_trees(tmp_path):
    """--n_data 2 needs two ranks (one card each; the multi-rank run:
    test_torch_port_multihost.py), as JAX's mesh needs two devices."""
    tree = _tree(tmp_path / "data", "npy")
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        tpredict.main([str(tree), "--n_data", "2", "--device", "cpu"] + FLAGS)
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no volumes"):
        tpredict.main([str(tmp_path / "empty"), "--device", "cpu"] + FLAGS)


def test_predict_batches_go_to_the_device_once(ckpt, tmp_path, monkeypatch):
    """Every batch (the padded tail too) is copied once, through
    core.device.to_device, at the full batch size."""
    from octcubem_tpu_torch.core import device as dev

    seen = []
    real = dev.to_device

    def spy(batch, device):
        seen.append(batch.shape)
        return real(batch, device)

    monkeypatch.setattr(dev, "to_device", spy)
    tree = _tree(tmp_path / "data", "npy")
    (tmp_path / "o").mkdir()
    _run(tpredict.main, tree, tmp_path / "o", ["--device", "cpu"])
    assert seen == [(2, 6, 32, 32, 1)] * 2
    assert os.path.exists(tmp_path / "o" / "p.csv")
