"""Port parity: cli/parity_check.py and the model registry against the
JAX package on the CPU.  Both CLIs read one checkpoint and one .npz of
reference inputs and logits, and must give the same exit code: 0 on the
JAX model's own logits (PASS), 1 on logits moved past --atol (FAIL),
with the same per-disease argmax agreement line."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from octcubem_tpu.cli import parity_check as jpc
from octcubem_tpu.compat.torch_export import (export_state_dict,
                                              save_torch_checkpoint)
from octcubem_tpu.models import registry as jreg
from octcubem_tpu.models import vit_st as jvit
from octcubem_tpu_torch.cli import parity_check as tpc
from octcubem_tpu_torch.models import mae3d as tmae
from octcubem_tpu_torch.models import registry as treg
from octcubem_tpu_torch.models import vit_st as tvit

KW = dict(num_frames=6, t_patch_size=3, img_size=32, in_chans=1,
          num_classes=16, embed_dim=64, depth=2, num_heads=2,
          head_type="dropout")
ARGS = ["--num_frames", "6", "--input_size", "32", "--embed_dim", "64",
        "--depth", "2", "--num_heads", "2"]


@pytest.fixture(autouse=True)
def _restore_jax_precision():
    """The JAX CLIs set the global matmul precision; put it back."""
    before = jax.config.jax_default_matmul_precision
    yield
    jax.config.update("jax_default_matmul_precision", before)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("parity")
    jm = jvit.VisionTransformerST(**KW, attn_impl="naive")
    x = np.random.default_rng(0).standard_normal(
        (2, 6, 32, 32, 1)).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.key(2), jnp.asarray(x))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    logits = np.asarray(jvit.VisionTransformerST(
        **KW, attn_impl="flash").apply(params, jnp.asarray(x)))
    ckpt = str(d / "cls.pth")
    save_torch_checkpoint(ckpt, export_state_dict(params, style="flash"))
    good, moved, torch_layout = (str(d / n) for n in
                                 ("good.npz", "moved.npz", "bcthw.npz"))
    np.savez(good, inputs=x, expected_logits=logits)
    moved_logits = logits.copy()
    moved_logits[1, 3] += 0.01  # past the default atol 1e-3
    np.savez(moved, inputs=x, expected_logits=moved_logits)
    np.savez(torch_layout, inputs=x.transpose(0, 4, 1, 2, 3),
             expected_logits=logits)
    return ckpt, good, moved, torch_layout


def _run(main, argv, capsys):
    code = main(argv)
    out = capsys.readouterr().out
    agree = next(s for s in out.splitlines() if s.startswith("per-disease"))
    verdict = out.strip().splitlines()[-1]
    return code, agree, verdict


@pytest.mark.parametrize("which,code", [("good", 0), ("moved", 1),
                                        ("bcthw", 0)])
def test_exit_codes_match_jax(files, capsys, which, code):
    ckpt, good, moved, bcthw = files
    npz = {"good": good, "moved": moved, "bcthw": bcthw}[which]
    jres = _run(jpc.main, [ckpt, npz] + ARGS, capsys)
    tres = _run(tpc.main, [ckpt, npz] + ARGS + ["--device", "cpu"], capsys)
    assert jres[0] == tres[0] == code
    assert tres[1:] == jres[1:]
    assert tres[2] == ("PARITY: PASS" if code == 0 else "PARITY: FAIL")


def test_registry_serves_the_ported_families():
    m = treg.create_model("vit_st_dropout", "vit_base_patch16", device="cpu",
                          num_frames=6, img_size=32, depth=1, num_classes=4)
    ref = tvit.create_model(tvit.vit_base_patch16, device="cpu", seed=0,
                            num_frames=6, img_size=32, depth=1, num_classes=4,
                            head_type="dropout")
    assert m.head_type == "dropout" and not m.training
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                 ref.state_dict().values()))
    assert treg.create_model("vit_st", "flash_attn_vit_large_patch16",
                             device="cpu", num_frames=3,
                             img_size=16, depth=1, num_classes=2
                             ).head_type == "aggregate"
    mae = treg.create_model("mae3d", "mae_vit_base_patch16", device="cpu",
                            depth=1, decoder_depth=1, num_frames=6,
                            input_size=32, high_res_input_size=64,
                            pred_t_dim=6)
    assert isinstance(mae, tmae.MaskedAutoencoderViT3D) and mae.training
    with pytest.raises(KeyError, match="unknown model"):
        treg.create_model("vit_st", "no_such_model")
    with pytest.raises(KeyError):
        jreg.create_model("vit_st", "no_such_model")


# the families ROADMAP A12 ported: each registry name builds a model that
# forwards equal to the JAX registry's on the same weights (fp32, 5e-5)
REGISTRY_A12 = {
    "vit2d": ("vit_large_patch16", dict(img_size=32, in_chans=1,
                                        num_classes=3), (2, 32, 32, 1)),
    "vit_3dhead": ("vit_large_patch16", dict(img_size=32, in_chans=1,
                                             num_classes=3), (1, 2, 32, 32, 1)),
    "slivit": ("slivit_baseline", dict(num_classes=2, num_frames=2,
                                       img_size=32, slivit_depth=1,
                                       convnext_depths=(1, 1, 1, 1),
                                       convnext_dims=(8, 8, 8, 16)),
               (1, 2, 32, 32, 1)),
}


@pytest.mark.parametrize("family,item", [("vit2d", "A12"),
                                         ("vit_3dhead", "A12"),
                                         ("slivit", "A12")])
def test_registry_names_what_is_not_ported(family, item):
    """Once named as not ported (ROADMAP ``item``), now built by both
    registries: the port's forward equals JAX's on JAX's weights."""
    from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax

    assert family in jreg._FAMILIES and item == "A12"
    name, kw, shape = REGISTRY_A12[family]
    # the ViT-L constructors at one block (the port's take depth)
    small = {} if family == "slivit" else dict(depth=1)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    if family == "slivit":
        jm = jreg.create_model(family, name, **kw)
    else:
        # the JAX constructors fix depth and width: the classes directly
        from octcubem_tpu.models import vit2d, vit_3dhead

        cls = (vit2d.VisionTransformer2D if family == "vit2d"
               else vit_3dhead.VisionTransformer3DHead)
        jm = cls(**kw, embed_dim=1024, depth=1, num_heads=16,
                 attn_impl="naive")
    params = jax.jit(jm.init)(jax.random.key(1), jnp.asarray(x))
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    tm = treg.create_model(family, name, device="cpu", **kw, **small)
    assert not tm.training
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=5e-5)


def test_coem_configs_wait_for_a13():
    assert jreg.list_coem_configs()  # the JAX package has them
    with pytest.raises(NotImplementedError, match="A13"):
        treg.list_coem_configs()
    with pytest.raises(NotImplementedError, match="A13"):
        treg.create_coem_model("coem2")
