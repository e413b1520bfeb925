"""The port's package rules: no JAX anywhere in it, the card by default,
and weights that carry across from the JAX package exactly."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from octcubem_tpu.compat.torch_export import (export_state_dict,
                                              save_torch_checkpoint,
                                              to_retfound_layout)
from octcubem_tpu.compat.torch_import import load_torch_checkpoint as jax_load
from octcubem_tpu.models import vit_st as jvit
from octcubem_tpu_torch import entry as tentry
from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.compat.torch_import import load_torch_checkpoint
from octcubem_tpu_torch.core.device import resolve_device
from octcubem_tpu_torch.models import vit_st as tvit

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "octcubem_tpu")
KW = dict(num_frames=6, t_patch_size=3, img_size=32, patch_size=16,
          in_chans=1, num_classes=4, embed_dim=32, depth=2, num_heads=1)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "octcubem_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    scanned = {str(f.relative_to(ROOT)) for f in files}
    assert {"octcubem_tpu_torch/parallel/__init__.py",
            "octcubem_tpu_torch/parallel/sequence.py",
            "octcubem_tpu_torch/core/mesh.py",
            "octcubem_tpu_torch/scripts/kablate.py",
            "octcubem_tpu_torch/data/dicom.py",
            "octcubem_tpu_torch/compat/aot.py",
            "octcubem_tpu_torch/ops/quant.py",
            "octcubem_tpu_torch/ops/pos_embed.py",
            "octcubem_tpu_torch/utils/saliency.py",
            "octcubem_tpu_torch/utils/visualization.py",
            "octcubem_tpu_torch/models/mae2d.py",
            "octcubem_tpu_torch/models/registry.py",
            "octcubem_tpu_torch/cli/parity_check.py",
            "octcubem_tpu_torch/core/config.py",
            "octcubem_tpu_torch/core/runtime.py",
            "octcubem_tpu_torch/core/multihost.py",
            "octcubem_tpu_torch/utils/logging.py",
            "octcubem_tpu_torch/utils/profiling.py",
            "octcubem_tpu_torch/native/__init__.py",
            "octcubem_tpu_torch/data/ingest.py",
            "octcubem_tpu_torch/data/randaug.py",
            "octcubem_tpu_torch/data/transforms.py",
            "octcubem_tpu_torch/data/patients.py",
            "octcubem_tpu_torch/data/loader.py",
            "octcubem_tpu_torch/data/spl.py",
            "octcubem_tpu_torch/cli/pretrain.py",
            "octcubem_tpu_torch/models/vit2d.py",
            "octcubem_tpu_torch/models/vit_3dhead.py",
            "octcubem_tpu_torch/models/slivit.py",
            "octcubem_tpu_torch/train/losses.py",
            "octcubem_tpu_torch/train/metrics.py",
            "octcubem_tpu_torch/train/finetune_engine.py",
            "octcubem_tpu_torch/data/aireadi.py",
            "octcubem_tpu_torch/data/crossmodal.py",
            "octcubem_tpu_torch/cli/finetune.py",
            "octcubem_tpu_torch/cli/predict.py"} <= scanned
    # the native directory holds its C++ source beside the binding, and
    # no file of the JAX package's (nor its prebuilt library)
    native = sorted(p.name for p in
                    (ROOT / "octcubem_tpu_torch" / "native").iterdir()
                    if p.name != "__pycache__")
    assert native == ["__init__.py", "volume_loader.cpp"]
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []
    # the card's machine has no scikit-learn: the metrics are numpy + scipy
    sk = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
          if m.split(".")[0] == "sklearn"]
    assert sk == []


def test_resolve_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        tentry.entry()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.fixture(scope="module", params=["dropout", "aggregate"])
def jax_params(request):
    model = jvit.VisionTransformerST(**KW, head_type=request.param,
                                     attn_impl="naive")
    params = model.init(jax.random.key(0), jnp.zeros((1, 6, 32, 32, 1)))
    return request.param, params


def test_state_dict_from_jax_loads_strict(jax_params):
    head_type, params = jax_params
    sd = state_dict_from_jax(params)
    ref = export_state_dict(params, style="flash")
    assert set(sd) == set(ref)
    for k, v in sd.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    model = tvit.VisionTransformerST(**KW, head_type=head_type)
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    # without the "params" root too
    assert set(state_dict_from_jax(params["params"])) == set(ref)


def test_load_torch_checkpoint(jax_params, tmp_path):
    head_type, params = jax_params
    flash = export_state_dict(params, style="flash")
    path = str(tmp_path / "flash.pth")
    save_torch_checkpoint(path, flash, extra={"epoch": 3})
    sd = load_torch_checkpoint(path)
    model = tvit.create_model(tvit.VisionTransformerST, device="cpu",
                              state_dict=sd, head_type=head_type, **KW)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), flash[k], err_msg=k)

    # the RETFound layout reads as the file holds it, as JAX's loader reads
    # it, and converts on import (more layouts: test_torch_port_import.py)
    other = str(tmp_path / "retfound.pth")
    retfound = to_retfound_layout(flash)
    save_torch_checkpoint(other, retfound)
    sd = load_torch_checkpoint(other)
    assert set(sd) == set(retfound) == set(jax_load(other))
    model = tvit.create_model(tvit.VisionTransformerST, device="cpu",
                              state_dict=sd, head_type=head_type, **KW)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), flash[k], err_msg=k)


@pytest.mark.parametrize("kw,item", [
    (dict(capture_cam=True), "A10"),
    (dict(remat=True, capture_cam=True), "A10"),
    (dict(quant=True), "A10"),
    pytest.param(dict(attn_impl="flash_tp"), "A14", id="kw3-A14")])
def test_unported_model_options_raise(kw, item):
    """The options A10 ported build and run (their parity tests are
    test_torch_port_{saliency,quant}.py); the head-parallel attention
    (A14) runs on a one-rank gloo group's tp mesh and gives the flash
    model's logits (its multi-rank parity: test_torch_port_tp.py)."""
    model = tvit.create_model(tvit.VisionTransformerST, device="cpu", **KW,
                              **kw)
    x = torch.zeros((1, 6, 32, 32, 1))
    if item == "A14":
        import torch.distributed as dist
        from octcubem_tpu_torch.core import multihost
        from octcubem_tpu_torch.parallel.tensor import (shard_tp_params,
                                                        use_tensor_parallel)
        from torch.distributed.device_mesh import DeviceMesh

        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            x.shape).astype(np.float32))
        flash = tvit.create_model(tvit.VisionTransformerST, device="cpu",
                                  **KW)
        with pytest.raises(RuntimeError, match="use_tensor_parallel"):
            model(x)
        tmp = Path(__import__("tempfile").mkdtemp())
        multihost.initialize(store=dist.FileStore(str(tmp / "s"), 1),
                             world_size=1, rank=0, device="cpu")
        try:
            mesh = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("tp",))
            shard_tp_params(model, mesh)
            with torch.no_grad(), use_tensor_parallel(mesh):
                out = model(x)
        finally:
            multihost.shutdown()
        with torch.no_grad():
            np.testing.assert_array_equal(out.numpy(), flash(x).numpy())
        return
    with torch.no_grad():
        assert torch.isfinite(model(x)).all()


def test_create_model_is_seeded():
    a = tvit.create_model(tvit.VisionTransformerST, device="cpu", seed=1, **KW)
    b = tvit.create_model(tvit.VisionTransformerST, device="cpu", seed=1, **KW)
    c = tvit.create_model(tvit.VisionTransformerST, device="cpu", seed=2, **KW)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["blocks.0.mixer.Wqkv.weight"],
                           sc["blocks.0.mixer.Wqkv.weight"])
    assert torch.isfinite(a(torch.zeros((1, 6, 32, 32, 1)))).all()


@pytest.mark.parametrize("where", ["checkout", "override", "installed"])
def test_kernel_build_dir(monkeypatch, tmp_path, where):
    """Libraries go under build/ in a checkout, to $OCTCUBEM_TPU_TORCH_BUILD
    when set, and to a per-user cache (never the package's own, possibly
    read-only directory) for an installed package."""
    from octcubem_tpu_torch.ops import _cuda

    monkeypatch.delenv("OCTCUBEM_TPU_TORCH_BUILD", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    want = ROOT / "build" / "octcubem_tpu_torch"
    if where == "override":
        monkeypatch.setenv("OCTCUBEM_TPU_TORCH_BUILD", str(tmp_path / "b"))
        want = tmp_path / "b"
    elif where == "installed":
        monkeypatch.setattr(_cuda, "_ROOT", tmp_path / "site-packages")
        want = tmp_path / "cache" / "octcubem_tpu_torch"
    assert _cuda.build_dir() == want
    lib = _cuda.lib_path("flash_fwd_packed")
    assert lib.parent == want and lib.name.startswith("libflash_fwd_packed_")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_package(tmp_path, alone):
    """No card (this machine), or the script alone in a directory: a
    nonzero exit and no result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
