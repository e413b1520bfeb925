"""Port parity for models/slivit.py: the SLIViT baseline (ConvNeXt trunk +
compact ViT head) and the ViT-ST trunk with a SLIViT head, against the
JAX package, weights carried by compat.jax_params.state_dict_from_jax
(its conv rule: flax [kh, kw, Cin, Cout] -> [Cout, Cin, kh, kw]).  Small
geometry: ConvNeXt dims (8, 8, 8, 16), one block a stage, 32-pixel
slices; the ViT-ST trunk at embed 128, 2 heads, depth 2.  Every weight is
the init plus noise, so conv kernels are asymmetric and a transposed
kernel changes the output.  fp32 forward at 5e-5 and per-leaf gradients
at 5e-4 of the leaf's largest entry; bf16 forwards at 2e-2 (3e-2 for the
ConvNeXt, whose bf16 convolutions round in other places than XLA's);
layer-decay scales key by key; and one run of each package's fine-tune
CLI on the SLIViT presets (ct3d on a MedMNIST .npz, us3d synthetic)."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octcubem_tpu.cli import finetune as jfinetune
from octcubem_tpu.models import slivit as jsl
from octcubem_tpu.train import optim as joptim
from octcubem_tpu_torch.cli import finetune as tfinetune
from octcubem_tpu_torch.compat import jax_params
from octcubem_tpu_torch.compat.jax_params import state_dict_from_jax
from octcubem_tpu_torch.models import registry as treg
from octcubem_tpu_torch.models import slivit as tsl
from octcubem_tpu_torch.train import optim as toptim

GRAD_REL = 5e-4
BASE = dict(num_patches=2, num_classes=2, slice_size=32, vit_depth=1,
            convnext_depths=(1, 1, 1, 1), convnext_dims=(8, 8, 8, 16))
HEAD = dict(num_classes=2, slivit_depth=1, num_frames=6, t_patch_size=3,
            img_size=32, in_chans=1, embed_dim=128, depth=2, num_heads=2)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


def _models(kind, dtype=None):
    jd = {} if dtype is None else {"dtype": dtype[0]}
    td = {} if dtype is None else {"dtype": dtype[1]}
    if kind == "baseline":
        return jsl.SLIViT(**BASE, **jd), tsl.SLIViT(**BASE, **td), (2, 2, 32,
                                                                    32, 1)
    return (jsl.vit_large_patch16_slivit(**HEAD, **jd),
            tsl.vit_large_patch16_slivit(**HEAD, **td), (2, 6, 32, 32, 1))


@pytest.fixture(scope="module", params=["baseline", "vit_st_head"])
def case(request):
    jm, _, shape = _models(request.param)
    x = _x(shape, 1)
    params = _perturb(jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x)), 2)
    return request.param, params, x


def test_forward_and_grads_match_jax(case):
    kind, params, x = case
    jm, tm, _ = _models(kind)
    w = _x((2, 2), 3)

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x))
        return (out * w).sum(), out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    out = tm(torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=5e-5, rtol=5e-5)
    ref_grads = state_dict_from_jax(jgrads)
    for name, p in tm.named_parameters():
        r = ref_grads[name].numpy()
        tol = GRAD_REL * max(np.abs(r).max(), 1e-8)
        np.testing.assert_allclose(p.grad.numpy(), r, atol=tol, rtol=0,
                                   err_msg=name)


def test_bf16_forward_matches_jax(case):
    kind, params, x = case
    jm, tm, _ = _models(kind, (jnp.bfloat16, torch.bfloat16))
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)), np.float32)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).float().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=3e-2 if kind == "baseline"
                               else 2e-2, rtol=0)


def test_conv_kernels_carry_their_spatial_axes(monkeypatch):
    """The conv rule keeps kh and kw apart: the kernels are asymmetric, and
    the bare transpose that Dense kernels take ([kh, kw, I, O].T = [O, I,
    kw, kh]) moves the output away from JAX's."""
    jm, tm, shape = _models("baseline")
    x = _x(shape, 4)
    params = _perturb(jax.jit(jm.init)(jax.random.key(5), jnp.asarray(x)), 6)
    dw = np.asarray(params["params"]["feature_extractor"]["stage0_block0"]
                    ["dwconv"]["kernel"])
    assert not np.allclose(dw, dw.transpose(1, 0, 2, 3))
    sd = state_dict_from_jax(params)
    np.testing.assert_array_equal(
        sd["feature_extractor.stage0_block0.dwconv.weight"].numpy(),
        dw.transpose(3, 2, 0, 1))
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        good = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(good, ref, atol=5e-5, rtol=5e-5)
    monkeypatch.setattr(jax_params, "_is_conv", lambda module: False)
    bad_sd = state_dict_from_jax(params)
    tm.load_state_dict(bad_sd, strict=True)
    with torch.no_grad():
        bad = tm(torch.from_numpy(x)).numpy()
    assert np.abs(bad - ref).max() > 100 * np.abs(good - ref).max() + 1e-4


@pytest.mark.parametrize("kind", ["baseline", "vit_st_head"])
def test_layer_decay_scales_match_jax_key_by_key(kind):
    """JAX matches blocks/blocks_N/ and names starting with an embedding's:
    the SLIViT modules (stage0_block0, blocks_0_to_qkv, ...) all take the
    head's scale, and only a ViT-ST trunk's blocks decay.  Both SLIViTs
    have no depth field, so JAX's CLI counts 24 blocks."""
    jm, tm, shape = _models(kind)
    params = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros(shape))
    assert getattr(jm, "depth", 24) == getattr(tm, "depth", 24) == 24
    for rooted in (False, True):
        tree = params if rooted else params["params"]
        js = joptim.layer_decay_scales(tree, 24, 0.65)
        full = jax.tree.map(lambda s, p: np.full(p.shape, s, np.float32),
                            js, tree)
        want = {k: float(v.flatten()[0])
                for k, v in state_dict_from_jax(full).items()}
        got = toptim.layer_decay_scales(tm, 24, 0.65,
                                        "params." if rooted else "")
        assert set(got) == set(want)
        assert got == pytest.approx(want, rel=1e-6)
    n_distinct = len(set(got.values()))
    assert n_distinct == (1 if kind == "baseline" else 3)


def test_registry_builds_both_slivits():
    m = treg.create_model("slivit", "slivit_baseline", device="cpu",
                          num_classes=2, num_frames=2, img_size=32,
                          slivit_depth=1, convnext_depths=(1, 1, 1, 1),
                          convnext_dims=(8, 8, 8, 16))
    assert isinstance(m, tsl.SLIViT) and not m.training
    gammas = [p for n, p in m.named_parameters() if n.endswith("gamma")]
    assert gammas and all(torch.all(g == 1e-6) for g in gammas)
    m = treg.create_model("slivit", "vit_large_patch16_slivit", device="cpu",
                          **dict(HEAD, depth=1))
    assert isinstance(m, tsl.ViTSTWithSLIViTHead)
    assert not any(n.startswith(("trunk.head", "trunk.norm"))
                   for n in m.state_dict())


# ------------------------------------------- the CLI on the SLIViT presets

def _medmnist(path):
    rng = np.random.default_rng(0)

    def mk(n):
        return (rng.integers(0, 255, (n, 28, 28, 28), dtype=np.uint8),
                rng.integers(0, 2, (n, 1), dtype=np.int64))

    tr, va, te = mk(8), mk(4), mk(4)
    np.savez(path, train_images=tr[0], train_labels=tr[1],
             val_images=va[0], val_labels=va[1], test_images=te[0],
             test_labels=te[1])


@pytest.fixture(scope="module", params=["ct3d", "us3d"])
def slivit_runs(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"slivit_{request.param}")
    if request.param == "ct3d":
        npz = root / "nodulemnist3d.npz"
        _medmnist(npz)
        flags = ["--slivit_dataset", "ct3d", "--tiny", "--data_dir",
                 str(npz), "--epochs", "1", "--batch_size", "4"]
    else:
        flags = ["--slivit_dataset", "us3d", "--tiny", "--synthetic",
                 "--synthetic_n", "20", "--epochs", "1", "--batch_size", "4"]
    cwd = os.getcwd()
    try:
        for name, main, extra in (("jax", jfinetune.main, []),
                                  ("port", tfinetune.main,
                                   ["--device", "cpu"])):
            (root / name).mkdir()
            os.chdir(root / name)
            main(flags + ["--output_dir", "out"] + extra)
    finally:
        os.chdir(cwd)
    return request.param, root / "jax" / "out", root / "port" / "out"


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_slivit_cli_writes_what_jax_writes(slivit_runs):
    """The same args.json, the same files (metric CSVs, confusion images,
    logs, checkpoint epoch) and the same CSV columns and row counts."""
    kind, jout, tout = slivit_runs
    assert (jout / "args.json").read_text() == (tout / "args.json").read_text()
    files = [sorted(f for f in os.listdir(d) if not f.startswith("tb"))
             for d in (jout, tout)]
    assert files[0] == files[1]
    assert "macro_metrics_val.csv" in files[1]
    if kind == "ct3d":
        assert "confusion_test.png" in files[1]
    for f in files[0]:
        if f.endswith(".csv"):
            a, b = _rows(jout / f), _rows(tout / f)
            assert a[0] == b[0] and len(a) == len(b)
    assert sorted(os.listdir(tout / "ckpt")) == sorted(os.listdir(
        jout / "ckpt"))
