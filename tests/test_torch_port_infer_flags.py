"""cli/infer.py takes the JAX CLI's command lines (ROADMAP C7): the same
argument list through both packages' ``infer.main``, ``--attn_impl
naive`` and the five flags that have no effect at inference (``--model``,
``--drop_path``, ``--global_pool``, ``--sep_pos_embed``, ``--cls_embed``)
included, gives equal probabilities; ``--attn_impl`` reaches the model;
``infer`` and ``serve`` set up the kernel build as the JAX CLIs set up
their compile cache.  Both CLIs build ``flash_attn_vit_large_patch16``,
cut here to a narrow ViT."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octcubem_tpu.cli import infer as jinfer
from octcubem_tpu.compat import torch_export as jexport
from octcubem_tpu.models import vit_st as jvst
from octcubem_tpu_torch.cli import infer as tinfer
from octcubem_tpu_torch.cli import serve as tserve
from octcubem_tpu_torch.core import runtime
from octcubem_tpu_torch.models import vit_st as tvst

GEOM = ["--num_frames", "6", "--input_size", "32", "--nb_classes", "4",
        "--num_heads", "2"]
NO_OPS = ["--model", "flash_attn_vit_large_patch16", "--drop_path", "0.1",
          "--global_pool", "--sep_pos_embed", "--cls_embed"]


@pytest.fixture(autouse=True)
def _restore_jax_precision():
    before = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", before)


@pytest.fixture
def small_vit_l(monkeypatch):
    monkeypatch.setattr(jvst, "flash_attn_vit_large_patch16",
                        functools.partial(jvst.VisionTransformerST,
                                          embed_dim=64, depth=2))
    monkeypatch.setattr(tvst, "flash_attn_vit_large_patch16",
                        functools.partial(tvst.VisionTransformerST,
                                          embed_dim=64, depth=2))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("infer")
    jm = jvst.VisionTransformerST(
        num_frames=6, t_patch_size=3, img_size=32, in_chans=1, num_classes=4,
        embed_dim=64, depth=2, num_heads=2, head_type="dropout",
        attn_impl="naive")
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 6, 32, 32, 1)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.05 *
                          rng.standard_normal(a.shape).astype(np.float32),
                          params)
    ckpt = str(d / "m.pth")
    jexport.save_torch_checkpoint(ckpt, jexport.export_state_dict(params))
    vol = str(d / "vol.npy")
    np.save(vol, (rng.random((8, 40, 40)) * 255).astype(np.float32))
    return vol, ckpt


@pytest.mark.parametrize("attn_impl", ["naive", "auto"])
def test_infer_takes_jax_command_lines(files, small_vit_l, attn_impl, capsys):
    vol, ckpt = files
    argv = [vol, "--ckpt", ckpt, "--attn_impl", attn_impl] + NO_OPS + GEOM
    jprobs = jinfer.main(argv)
    jout = capsys.readouterr().out
    tprobs = tinfer.main(argv + ["--device", "cpu"])
    tout = capsys.readouterr().out
    np.testing.assert_allclose(tprobs, jprobs, atol=5e-5, rtol=5e-5)
    assert tout.splitlines()[-1] == jout.splitlines()[-1]


def test_attn_impl_reaches_the_model(files, small_vit_l, monkeypatch):
    vol, ckpt = files
    seen = []
    real = tinfer.build_model

    def spy(args, device):
        model = real(args, device)
        seen.append({m.attn_impl for m in model.modules()
                     if hasattr(m, "attn_impl")})
        return model

    monkeypatch.setattr(tinfer, "build_model", spy)
    for impl in ("naive", "flash"):
        tinfer.main([vol, "--ckpt", ckpt, "--attn_impl", impl, "--device",
                     "cpu"] + GEOM)
    assert seen == [{"naive"}, {"flash"}]
    with pytest.raises(ValueError, match="unknown attention impl"):
        tinfer.main([vol, "--attn_impl", "bogus", "--device", "cpu"] + GEOM)


def test_infer_and_serve_set_up_the_kernel_build(files, small_vit_l,
                                                 monkeypatch):
    """Both call core.runtime.setup_compilation_cache with their device
    (which builds nothing for the CPU)."""
    vol, ckpt = files
    calls = []
    monkeypatch.setattr(runtime, "setup_compilation_cache",
                        lambda cache_dir=None, device=None: calls.append(
                            torch.device(device).type))
    tinfer.main([vol, "--device", "cpu"] + GEOM)

    def stop(args):
        raise KeyboardInterrupt

    monkeypatch.setattr(tserve, "build_predictor", stop)
    with pytest.raises(KeyboardInterrupt):
        tserve.main(["--device", "cpu", "--port", "0"])
    assert calls == ["cpu", "cpu"]
