"""Port parity: the port's copy of the DICOM reader and writer
(data/dicom.py) and infer on a .dcm against the JAX package on the CPU.
"""

import functools

import numpy as np
import pytest
import jax

from octcubem_tpu.cli import infer as jinfer
from octcubem_tpu.compat.torch_export import (export_state_dict,
                                              save_torch_checkpoint)
from octcubem_tpu.data import dicom as jdicom
from octcubem_tpu.models import vit_st as jvit
from octcubem_tpu_torch.cli import infer as tinfer
from octcubem_tpu_torch.data import dicom as tdicom
from octcubem_tpu_torch.models import vit_st as tvit


@pytest.fixture(autouse=True)
def _restore_jax_precision():
    """The JAX CLIs set the global matmul precision; put it back."""
    before = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", before)


def _volume(dtype, shape=(5, 12, 10), seed=0):
    hi = np.iinfo(dtype).max
    return np.random.default_rng(seed).integers(0, hi, shape, dtype=dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("implicit", [False, True])
def test_read_write_match_jax(tmp_path, dtype, implicit):
    """Each package's writer makes the same bytes; each reader reads both
    files to the same elements and pixel array."""
    vol = _volume(dtype)
    tpath, jpath = str(tmp_path / "t.dcm"), str(tmp_path / "j.dcm")
    tdicom.write_dicom(tpath, vol, manufacturer="Topcon", model="Maestro",
                       implicit=implicit)
    jdicom.write_dicom(jpath, vol, manufacturer="Topcon", model="Maestro",
                       implicit=implicit)
    with open(tpath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    for path in (tpath, jpath):
        got, ref = tdicom.read_dicom(path), jdicom.read_dicom(path)
        assert got.elements == ref.elements
        assert (got.manufacturer, got.model_name) == ("Topcon", "Maestro")
        assert got.pixel_array.dtype == ref.pixel_array.dtype == dtype
        np.testing.assert_array_equal(got.pixel_array, vol)


def test_single_frame_and_refusals_match_jax(tmp_path):
    img = _volume(np.uint8, shape=(7, 9))
    path = str(tmp_path / "one.dcm")
    tdicom.write_dicom(path, img)
    assert tdicom.read_dicom(path).pixel_array.shape == (7, 9)
    bad = tmp_path / "bad.dcm"
    bad.write_bytes(b"\x00" * 200)
    for mod in (tdicom, jdicom):
        with pytest.raises(ValueError, match="not a DICOM part-10 file"):
            mod.read_dicom(str(bad))


def test_process_volume_reads_dicom_like_jax(tmp_path):
    vol = _volume(np.uint16, shape=(10, 40, 36), seed=2)
    path = str(tmp_path / "v.dcm")
    tdicom.write_dicom(path, vol)
    got = tinfer.process_volume(path, 6, 32)
    np.testing.assert_allclose(got, jinfer.process_volume(path, 6, 32),
                               atol=1e-5, rtol=1e-6)
    npy = str(tmp_path / "v.npy")
    np.save(npy, vol.astype(np.float32))
    np.testing.assert_array_equal(got, tinfer.process_volume(npy, 6, 32))


@pytest.fixture
def small_vit_l(monkeypatch):
    """Both infer CLIs build ``flash_attn_vit_large_patch16``: cut to the
    test width."""
    narrow = dict(embed_dim=64, depth=2)
    monkeypatch.setattr(jvit, "flash_attn_vit_large_patch16",
                        functools.partial(jvit.VisionTransformerST, **narrow))
    monkeypatch.setattr(tvit, "flash_attn_vit_large_patch16",
                        functools.partial(tvit.VisionTransformerST, **narrow))


def test_infer_on_dicom_matches_jax(tmp_path, small_vit_l, capsys):
    """infer on a .dcm: the JAX CLI's probabilities (fp32, 1e-5) and
    printout, and the same as the volume given as .npy."""
    jm = jvit.VisionTransformerST(
        num_frames=6, t_patch_size=3, img_size=32, in_chans=1, num_classes=4,
        embed_dim=64, depth=2, num_heads=2, head_type="dropout",
        attn_impl="naive")
    params = jax.jit(jm.init)(jax.random.key(5), np.zeros((1, 6, 32, 32, 1),
                                                          np.float32))
    ckpt = str(tmp_path / "cls.pth")
    save_torch_checkpoint(ckpt, export_state_dict(params, style="flash"))
    vol = _volume(np.uint8, shape=(9, 48, 40), seed=3)
    dcm, npy = str(tmp_path / "v.dcm"), str(tmp_path / "v.npy")
    tdicom.write_dicom(dcm, vol)
    np.save(npy, vol)
    args = ["--ckpt", ckpt, "--num_frames", "6", "--input_size", "32",
            "--nb_classes", "4", "--num_heads", "2"]
    jprobs = jinfer.main([dcm] + args)
    jout = capsys.readouterr().out
    tprobs = tinfer.main([dcm] + args + ["--device", "cpu"])
    tout = capsys.readouterr().out
    np.testing.assert_allclose(tprobs, jprobs, atol=1e-5, rtol=0)
    assert tout.splitlines()[-1] == jout.splitlines()[-1]
    np.testing.assert_array_equal(
        tprobs, tinfer.main([npy] + args + ["--device", "cpu"]))
