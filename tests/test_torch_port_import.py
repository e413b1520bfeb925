"""The port's checkpoint importer and CLIs against the JAX package's, on the
reference layouts (CPU, small models).

Each layout is a .pth written here from seeded weights: the flash layout,
split ``attn.{q,k,v}``, RETFound's fused ``attn.qkv``, an MAE encoder +
decoder file (no head), a 14x14 spatial pos-embed grid for a 16x16 model,
16 temporal pos embeds for a 20-frame-tube model, and the
``{'model', 'args'}`` and ``{'state_dict'}`` wrappers.  For each:

- ``import_state_dict``: the port's params equal JAX's (1e-6, the numpy
  interpolations run the same fp32 steps), with the same missing and
  unexpected sets, compared through the port's key rules
  (``compat.jax_params``: the port reports reference keys, JAX flax
  paths);
- ``cli/serve.py``'s build (``strict=False``, the geometry stamp) and
  ``cli/infer.py``'s (missing keys filled from init with a warning,
  unexpected keys an error), with the logits of the loaded model against
  the JAX model's on the same params (1e-5, fp32 through 2 blocks; where
  the file is complete, against the JAX server's own output);
- a file stamped with another head count is refused by both packages.

Also ``convert_retfound_2d_state_dict`` against JAX's, and export round
trips in both directions.
"""

import argparse
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from octcubem_tpu.cli import infer as jinfer
from octcubem_tpu.cli import serve as jserve
from octcubem_tpu.compat import torch_export as jexport
from octcubem_tpu.compat import torch_import as jimport
from octcubem_tpu.models import mae3d as jmae
from octcubem_tpu.models import vit_st as jvit
from octcubem_tpu_torch.cli import infer as tinfer
from octcubem_tpu_torch.cli import serve as tserve
from octcubem_tpu_torch.compat import torch_export as texport
from octcubem_tpu_torch.compat import torch_import as timport
from octcubem_tpu_torch.compat.jax_params import (_to_torch_key,
                                                  state_dict_from_jax)
from octcubem_tpu_torch.models import mae3d as tmae
from octcubem_tpu_torch.models import vit_st as tvit

TOL_PARAM = dict(rtol=1e-6, atol=1e-6)
TOL_LOGITS = dict(rtol=1e-5, atol=1e-5)
WIDTH = dict(embed_dim=32, depth=2, num_heads=2, patch_size=16)
# the classifier geometry each layout is served at: (frames, size)
BASE_GEOM = (6, 32)
LAYOUTS = ["flash", "split_qkv", "retfound", "mae", "grid14", "temporal16",
           "wrap_model_args", "wrap_state_dict"]
GEOM = {"grid14": (6, 256), "temporal16": (60, 32)}


def _jkey(name: str) -> str:
    """A JAX report name (flax path joined by '.') -> the reference key."""
    return _to_torch_key(tuple(name.split(".")))[0]


@functools.lru_cache(maxsize=None)
def _jax_classifier(frames, size, seed=0):
    model = jvit.VisionTransformerST(
        num_frames=frames, t_patch_size=3, img_size=size, in_chans=1,
        num_classes=4, head_type="dropout", global_pool=True, **WIDTH)
    params = jax.jit(model.init)(jax.random.key(seed),
                                 jnp.zeros((1, frames, size, size, 1)))
    return model, params


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


def _flash_sd(frames=6, size=32, seed=1) -> dict[str, np.ndarray]:
    _, params = _jax_classifier(frames, size)
    return jexport.export_state_dict(_perturbed(params, seed))


def _split_qkv(sd):
    out = {}
    for k, v in sd.items():
        if ".mixer.Wqkv." in k:
            pre, kind = k.split(".mixer.Wqkv.")
            for name, part in zip("qkv", np.split(v, 3, axis=0)):
                out[f"{pre}.attn.{name}.{kind}"] = part
        else:
            out[k.replace(".mixer.out_proj.", ".attn.proj.")] = v
    return out


def _mae_sd(seed=2):
    """An MAE file for the base classifier's encoder: its pos embeds at the
    high-res grid, a decoder, a mask token and no head."""
    m = tmae.MaskedAutoencoderViT3D(
        input_size=32, high_res_input_size=64, patch_size=16, in_chans=1,
        embed_dim=32, depth=2, num_heads=2, decoder_embed_dim=16,
        decoder_depth=1, decoder_num_heads=2, num_frames=6, t_patch_size=3,
        pred_t_dim=6)
    rng = np.random.default_rng(seed)
    # init-sized values: LayerNorm scales (the only 1-D weights) near 1,
    # the rest small (at unit weights the softmax saturates and fp32
    # rounding decides its argmax)
    return {k: (float(v.ndim == 1 and k.endswith(".weight"))
                + 0.05 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
            for k, v in m.state_dict().items()}


def _payload(layout):
    """(what torch.save writes, the classifier geometry)."""
    geom = GEOM.get(layout, BASE_GEOM)
    if layout == "grid14":
        sd = _flash_sd(*geom)
        d = sd["pos_embed_spatial"].shape[-1]
        sd["pos_embed_spatial"] = 0.05 * np.random.default_rng(
            3).standard_normal((1, 196, d)).astype(np.float32)
    elif layout == "temporal16":
        sd = _flash_sd(*geom)
        sd["pos_embed_temporal"] = 0.05 * np.random.default_rng(
            4).standard_normal((1, 16, 32)).astype(np.float32)
    elif layout == "mae":
        sd = _mae_sd()
    else:
        sd = _flash_sd()
        if layout == "split_qkv":
            sd = _split_qkv(sd)
        elif layout == "retfound":
            sd = jexport.to_retfound_layout(sd)
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    if layout == "wrap_model_args":
        return {"model": {f"module.{k}": v for k, v in tensors.items()},
                "epoch": 3, "args": argparse.Namespace(lr=1e-3)}, geom
    if layout == "wrap_state_dict":
        return {"state_dict": tensors, "epoch": 3}, geom
    return {"model": tensors}, geom


@pytest.fixture(scope="module", params=LAYOUTS)
def layout_file(request, tmp_path_factory):
    payload, geom = _payload(request.param)
    path = tmp_path_factory.mktemp("ckpt") / f"{request.param}.pth"
    torch.save(payload, path)
    return request.param, str(path), geom


def _assert_reports_equal(report, jreport):
    assert set(report["missing"]) == {_jkey(k) for k in jreport["missing"]}
    assert set(report["unexpected"]) == {
        _jkey(k) for k in jreport["unexpected"]}


def _assert_params_equal(sd, jparams, keys):
    ref = state_dict_from_jax(jparams)
    for k in keys:
        np.testing.assert_allclose(sd[k].detach().float().cpu().numpy(),
                                   ref[k].numpy(), **TOL_PARAM, err_msg=k)


# ------------------------------------------------------------ the importer

def test_import_state_dict_matches_jax(layout_file):
    layout, path, (frames, size) = layout_file
    _, jtemplate = _jax_classifier(frames, size, seed=5)
    jparams, jreport = jimport.import_state_dict(
        jtemplate, jimport.load_torch_checkpoint(path), strict=False)
    template = state_dict_from_jax(jtemplate)
    sd, report = timport.import_state_dict(
        template, timport.load_torch_checkpoint(path), strict=False)
    assert list(sd) == list(template)
    _assert_reports_equal(report, jreport)
    _assert_params_equal(sd, jparams, sd)
    if layout == "mae":
        assert set(report["missing"]) == {"head.weight", "head.bias"}
        assert "mask_token" in report["unexpected"]
        with pytest.raises(ValueError, match="unexpected"):
            timport.import_state_dict(template,
                                      timport.load_torch_checkpoint(path))
    else:
        assert report == {"missing": [], "unexpected": []}


@pytest.mark.parametrize("old_t,new_t,mode", [(16, 20, "interp"),
                                              (20, 16, "interp"),
                                              (20, 16, "crop"),
                                              (16, 20, "crop")])
def test_temporal_pos_embed_modes_match_jax(old_t, new_t, mode):
    """Linear interpolation both ways; crop takes the middle when shrinking
    and interpolates when growing, as in JAX."""
    _, jtemplate = _jax_classifier(3 * new_t, 32)
    sd = _flash_sd(3 * new_t, 32)
    sd["pos_embed_temporal"] = np.random.default_rng(6).standard_normal(
        (1, old_t, 32)).astype(np.float32)
    jparams, _ = jimport.import_state_dict(
        jtemplate, sd, smaller_interpolate_type=mode)
    got, _ = timport.import_state_dict(
        state_dict_from_jax(jtemplate), sd, smaller_interpolate_type=mode)
    _assert_params_equal(got, jparams, ["pos_embed_temporal"])
    if mode == "crop" and old_t > new_t:
        np.testing.assert_array_equal(got["pos_embed_temporal"].numpy(),
                                      sd["pos_embed_temporal"][:, 2:18])


def test_shape_mismatch_raises_as_in_jax():
    sd = _flash_sd()
    sd["head.weight"] = sd["head.weight"][:2]
    _, jtemplate = _jax_classifier(*BASE_GEOM)
    with pytest.raises(ValueError, match="shape mismatch"):
        jimport.import_state_dict(jtemplate, sd)
    with pytest.raises(ValueError, match="shape mismatch"):
        timport.import_state_dict(state_dict_from_jax(jtemplate), sd)


def test_drop_keys_match_jax():
    sd = _flash_sd()
    _, jtemplate = _jax_classifier(*BASE_GEOM, seed=7)
    jparams, jreport = jimport.import_state_dict(jtemplate, sd,
                                                 drop_keys=("head",))
    got, report = timport.import_state_dict(state_dict_from_jax(jtemplate),
                                            sd, drop_keys=("head",))
    _assert_reports_equal(report, jreport)
    assert set(report["missing"]) == {"head.weight", "head.bias"}
    _assert_params_equal(got, jparams, got)


# --------------------------------------------------------------- the CLIs

def _serve_args(path, frames, size, pkg):
    common = dict(aot=None, ckpt=path, precision="fp32", num_frames=frames,
                  input_size=size, nb_classes=4, embed_dim=32, depth=2,
                  num_heads=2, quant="none")
    if pkg == "port":
        common.update(device="cpu", seed=0)
    return argparse.Namespace(**common)


def _jax_reference(frames, size, port_sd, x):
    """The JAX classifier's logits on the port model's params."""
    jm, jtemplate = _jax_classifier(frames, size)
    jparams, report = jimport.import_state_dict(
        jtemplate, {k: v.detach().numpy() for k, v in port_sd.items()})
    assert report == {"missing": [], "unexpected": []}
    return np.asarray(jm.apply(jparams, jnp.asarray(x)))


def _volume(frames, size, seed=8):
    return np.random.default_rng(seed).random(
        (1, frames, size, size, 1), dtype=np.float32)


def test_serve_loads_like_jax(layout_file):
    """The JAX server's import (strict=False): the port's /healthz import
    report holds the same sets; its logits equal the JAX model's on the
    port's params (its init where the file has no value) and, for a
    complete file, the JAX server's own."""
    layout, path, (frames, size) = layout_file
    predict, meta = tserve.build_predictor(
        _serve_args(path, frames, size, "port"))
    japply, _ = jserve.build_predictor(_serve_args(path, frames, size, "jax"))
    _, jtemplate = _jax_classifier(frames, size)
    _, jreport = jimport.import_state_dict(
        jtemplate, jimport.load_torch_checkpoint(path), strict=False)
    _assert_reports_equal(meta["import"], jreport)

    kw = dict(num_frames=frames, t_patch_size=3, img_size=size, in_chans=1,
              num_classes=4, head_type="dropout", global_pool=True,
              embed_dim=32, depth=2, num_heads=2)
    init = tvit.create_model(tvit.VisionTransformerST, device="cpu", seed=0,
                             **kw).state_dict()
    expect, _ = timport.import_state_dict(
        init, timport.load_torch_checkpoint(path), strict=False)
    x = _volume(frames, size)
    got = predict(x)
    np.testing.assert_allclose(got, _jax_reference(frames, size, expect, x),
                               **TOL_LOGITS)
    if not jreport["missing"]:
        np.testing.assert_allclose(got, np.asarray(japply(x)), **TOL_LOGITS)


def _infer_args(path, frames, size, pkg):
    # both CLIs parse the JAX CLI's flags (ROADMAP C7); the port adds seed
    common = dict(ckpt=path, t_patch_size=3, num_frames=frames,
                  input_size=size, nb_classes=4, num_heads=2,
                  precision="fp32", model="flash_attn_vit_large_patch16",
                  drop_path=0.2, global_pool=True, sep_pos_embed=True,
                  cls_embed=True, attn_impl="auto", saliency_dir=None)
    if pkg == "port":
        common.update(seed=0)
    return argparse.Namespace(**common)


@pytest.fixture
def small_vit_l(monkeypatch):
    """Both infer CLIs build ``flash_attn_vit_large_patch16``: cut to the
    test width."""
    monkeypatch.setattr(jvit, "flash_attn_vit_large_patch16",
                        functools.partial(jvit.VisionTransformerST,
                                          embed_dim=32, depth=2))
    monkeypatch.setattr(tvit, "flash_attn_vit_large_patch16",
                        functools.partial(tvit.VisionTransformerST,
                                          embed_dim=32, depth=2))


def test_infer_loads_like_jax(layout_file, small_vit_l, capsys):
    """The JAX infer's import (strict=True): unexpected keys raise in both;
    otherwise the loaded params equal JAX's, the same missing keys are
    named in a warning, and the logits equal the JAX model's on the
    port's params."""
    layout, path, (frames, size) = layout_file
    targs = _infer_args(path, frames, size, "port")
    jargs = _infer_args(path, frames, size, "jax")
    if layout == "mae":
        with pytest.raises(ValueError, match="unexpected"):
            jinfer.build_model_and_params(jargs)
        with pytest.raises(ValueError, match="unexpected"):
            tinfer.build_model(targs, torch.device("cpu"))
        return
    _, jparams = jinfer.build_model_and_params(jargs)
    jout = capsys.readouterr().out
    model = tinfer.build_model(targs, torch.device("cpu"))
    out = capsys.readouterr().out
    assert ("warning: missing" in out) == ("warning: missing" in jout)
    assert f"Load checkpoint {path}" in out
    sd = model.state_dict()
    _assert_params_equal(sd, jparams, sd)
    x = _volume(frames, size)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _jax_reference(frames, size, sd, x),
                               **TOL_LOGITS)


def test_infer_warns_on_missing_keys_like_jax(tmp_path, small_vit_l, capsys):
    sd = _flash_sd()
    del sd["head.weight"], sd["head.bias"]
    path = str(tmp_path / "nohead.pth")
    jexport.save_torch_checkpoint(path, sd)
    jinfer.build_model_and_params(_infer_args(path, *BASE_GEOM, "jax"))
    jout = capsys.readouterr().out
    tinfer.build_model(_infer_args(path, *BASE_GEOM, "port"),
                       torch.device("cpu"))
    out = capsys.readouterr().out
    assert "warning: missing params filled from init" in jout
    line = next(s for s in out.splitlines() if s.startswith("warning:"))
    assert "'head.weight'" in line and "'head.bias'" in line


# ----------------------------------------------------- the geometry stamp

@pytest.mark.parametrize("stamp,refused", [
    ({"num_heads": 8}, True), ({"num_heads": 2}, False),
    ({"model": "vit"}, False), (None, False)])
def test_geometry_stamp_refused_like_jax(tmp_path, small_vit_l, stamp,
                                         refused):
    path = str(tmp_path / "stamped.pth")
    extra = {"octcubem_tpu_geometry": stamp} if stamp else None
    jexport.save_torch_checkpoint(path, _flash_sd(), extra=extra)
    for check in (jimport.check_geometry_stamp,
                  timport.check_geometry_stamp):
        if refused:
            with pytest.raises(SystemExit, match="num_heads=8"):
                check(path, 2)
        else:
            check(path, 2)
    if refused:  # both CLIs refuse before loading
        with pytest.raises(SystemExit, match="geometry stamp"):
            tserve.build_predictor(_serve_args(path, *BASE_GEOM, "port"))
        with pytest.raises(SystemExit, match="geometry stamp"):
            tinfer.build_model(_infer_args(path, *BASE_GEOM, "port"),
                               torch.device("cpu"))
        with pytest.raises(SystemExit, match="geometry stamp"):
            jserve.build_predictor(_serve_args(path, *BASE_GEOM, "jax"))


def test_decoder_stamp_checked_like_jax(tmp_path):
    path = str(tmp_path / "mae.pth")
    jexport.save_torch_checkpoint(path, _flash_sd(), extra={
        "octcubem_tpu_geometry": {"num_heads": 16, "decoder_num_heads": 4}})
    for check in (jimport.check_geometry_stamp,
                  timport.check_geometry_stamp):
        check(path, 16)
        check(path, 16, decoder_num_heads=4)
        with pytest.raises(SystemExit, match="decoder_num_heads=4"):
            check(path, 16, decoder_num_heads=16)


# ------------------------------------------------------- RETFound 2D init

def _retfound_2d(d=32, grid=14, seed=9):
    """A RETFound-layout ViT 2D MAE: flat pos_embed with its cls row, a
    Conv2d patch embed, fused attn.qkv; decoder pos embed as well."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sd = {"cls_token": r(1, 1, d), "pos_embed": r(1, 1 + grid * grid, d),
          "patch_embed.proj.weight": r(d, 1, 16, 16),
          "patch_embed.proj.bias": r(d),
          "decoder_pos_embed": r(1, 1 + grid * grid, 16),
          "norm.weight": r(d), "norm.bias": r(d), "mask_token": r(1, 1, 16)}
    for i in range(2):
        sd[f"blocks.{i}.attn.qkv.weight"] = r(3 * d, d)
        sd[f"blocks.{i}.attn.qkv.bias"] = r(3 * d)
        sd[f"blocks.{i}.attn.proj.weight"] = r(d, d)
        sd[f"blocks.{i}.norm1.weight"] = r(d)
    return sd


@pytest.mark.parametrize("duplicate", [True, False])
def test_convert_retfound_2d_matches_jax(duplicate):
    sd = _retfound_2d()
    ref = jimport.convert_retfound_2d_state_dict(sd, 3, 4, duplicate)
    got = timport.convert_retfound_2d_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, 3, 4, duplicate)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], **TOL_PARAM, err_msg=k)
    assert got["patch_embed.proj.weight"].shape == (32, 1, 3, 16, 16)
    assert got["pos_embed_spatial"].shape == (1, 16, 32)


def test_retfound_2d_into_mae_matches_jax():
    """The retfound_2_flash_attn chain: convert, then import into the 3D
    MAE (the missing temporal embeds and decoder blocks keep the init)."""
    kw = dict(input_size=32, high_res_input_size=64, patch_size=16,
              in_chans=1, embed_dim=32, depth=2, num_heads=2,
              decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2,
              num_frames=6, t_patch_size=3, pred_t_dim=6)
    jm = jmae.MaskedAutoencoderViT3D(**kw, attn_impl="naive")
    x = jnp.zeros((1, 6, 32, 32, 1))
    jtemplate = jax.jit(functools.partial(jm.init, mask_ratio=0.5))(
        {"params": jax.random.key(0), "masking": jax.random.key(1)}, x)
    conv = jimport.convert_retfound_2d_state_dict(_retfound_2d(), 3, 4)
    jparams, jreport = jimport.import_state_dict(jtemplate, conv,
                                                 strict=False)
    tconv = timport.convert_retfound_2d_state_dict(_retfound_2d(), 3, 4)
    got, report = timport.import_state_dict(state_dict_from_jax(jtemplate),
                                            tconv, strict=False)
    _assert_reports_equal(report, jreport)
    assert "pos_embed_temporal" in report["missing"]
    _assert_params_equal(got, jparams, got)
    model = tmae.MaskedAutoencoderViT3D(**kw)
    model.load_state_dict(got, strict=True)


# ------------------------------------------------------ export round trips

def test_jax_export_loads_in_port(tmp_path):
    _, params = _jax_classifier(*BASE_GEOM)
    params = _perturbed(params, 10)
    for style in ("flash", "retfound"):
        path = str(tmp_path / f"{style}.pth")
        jexport.save_torch_checkpoint(
            path, jexport.export_state_dict(params, style=style),
            extra={"octcubem_tpu_geometry": {"num_heads": 2}})
        timport.check_geometry_stamp(path, 2)
        model = tvit.create_model(
            tvit.VisionTransformerST, device="cpu", num_frames=6,
            t_patch_size=3, img_size=32, in_chans=1, num_classes=4,
            head_type="dropout", state_dict=timport.load_torch_checkpoint(
                path), **WIDTH)
        ref = state_dict_from_jax(params)
        for k, v in model.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), ref[k].numpy(),
                                          err_msg=f"{style} {k}")


def test_port_export_loads_in_jax(tmp_path):
    model = tvit.create_model(tvit.VisionTransformerST, device="cpu",
                              seed=11, num_frames=6, t_patch_size=3,
                              img_size=32, in_chans=1, num_classes=4,
                              head_type="dropout", **WIDTH)
    _, jtemplate = _jax_classifier(*BASE_GEOM)
    for style in ("flash", "retfound"):
        sd = texport.export_state_dict(model, style=style)
        assert all(v.dtype == torch.float32 and v.device.type == "cpu"
                   for v in sd.values())
        assert (".attn.qkv.weight" in "".join(sd)) == (style == "retfound")
        path = str(tmp_path / f"{style}.pth")
        texport.save_torch_checkpoint(
            path, sd, extra={"octcubem_tpu_geometry": {"num_heads": 8}})
        with pytest.raises(SystemExit, match="num_heads=8"):
            jimport.check_geometry_stamp(path, 2)
        jparams, report = jimport.import_state_dict(
            jtemplate, jimport.load_torch_checkpoint(path))
        assert report == {"missing": [], "unexpected": []}
        _assert_params_equal(model.state_dict(), jparams,
                             model.state_dict())
    with pytest.raises(ValueError, match="style"):
        texport.export_state_dict(model, style="timm")
