"""Read reference PyTorch checkpoints (counterpart of
octcubem_tpu/compat/torch_import.py).

The port's modules use the reference flash-attn layout
(``blocks.i.mixer.Wqkv`` / ``mixer.out_proj``), so a flash checkpoint maps
key for key.  The other reference layouts are converted with the JAX
package's rules, kept here as the port's own numpy copy:

- split ``attn.{q,k,v}`` linears and RETFound's fused ``attn.qkv`` become
  ``mixer.Wqkv``, ``attn.proj`` becomes ``mixer.out_proj``;
- a RETFound / ImageNet-MAE 2D checkpoint becomes the joint-res 3D MAE
  layout (``convert_retfound_2d_state_dict``);
- pos embeds whose grid differs from the model's are interpolated on load
  (spatial torch-bicubic, temporal linear or middle-crop).

``import_state_dict`` merges a checkpoint into a model's own weights:
params the file lacks keep the model's init (reported ``missing``), keys
with no slot are ``unexpected`` (an error only when ``strict``).  Reports
name reference keys, where the JAX package names flax paths.

``check_geometry_stamp`` refuses a file whose ``octcubem_tpu_geometry``
stamp (written by ``cli/export.py`` in either package) names another
head count than the model is built with: the attention tensors have the
same shapes at 8 or 16 heads, so such a file would load and silently
compute another function.
"""

from __future__ import annotations

import argparse
import pickle
import re
import warnings
from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..ops.resize import _interp_matrix_1d

# the reference save paths' wrappers (OCTCube/util/misc.py, COEM's
# main_retclip.py), in the order the JAX loader tries them
_WRAPPERS = ("model", "state_dict", "model_state", "teacher")
GEOMETRY_KEY = "octcubem_tpu_geometry"


def _load(path: str, mmap: bool = False):
    """torch.load with ``weights_only=True``, allowing the
    ``argparse.Namespace`` the reference saves under 'args'."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True,
                          mmap=mmap)


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference .pth -> {key: fp32 tensor} on the CPU, in the file's
    own layout (``import_state_dict`` converts it).  Unwraps the first of
    'model', 'state_dict', 'model_state' and 'teacher' that holds a dict
    (the JAX loader's order) and drops 'module.' prefixes."""
    ckpt = _load(path)
    for key in _WRAPPERS:
        if isinstance(ckpt, dict) and isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
            break
    return {k.removeprefix("module."): v.float()
            for k, v in ckpt.items() if isinstance(v, torch.Tensor)}


def check_geometry_stamp(path: str, num_heads: int,
                         decoder_num_heads: int | None = None) -> None:
    """Raise SystemExit when the file's geometry stamp names another
    ``num_heads`` (or ``decoder_num_heads``, when given) than the model is
    built with.  Files without a stamp (every reference checkpoint) and
    files this reader cannot open pass: the load itself reports those."""
    try:
        ckpt = _load(path, mmap=True)
    except RuntimeError:
        try:  # pre-zipfile .pth: mmap is unsupported
            ckpt = _load(path)
        except (RuntimeError, pickle.UnpicklingError):
            return
    except pickle.UnpicklingError:
        return
    geom = ckpt.get(GEOMETRY_KEY) if isinstance(ckpt, dict) else None
    checks = [("num_heads", num_heads, "--num_heads")]
    if decoder_num_heads is not None:
        checks.append(("decoder_num_heads", decoder_num_heads,
                       "--decoder_num_heads"))
    for field, built, flag in checks:
        stamped = (geom or {}).get(field)
        if stamped is not None and stamped != built:
            raise SystemExit(
                f"{path} was pretrained with {field}={stamped} (geometry "
                f"stamp), but this run builds the model with {field}="
                f"{built}.  The tensors load cleanly either way and the "
                "model would silently compute the WRONG function: pass "
                f"{flag} {stamped} (or the matching config).")


# ------------------------------------------------------------------ rules

def _fuse_qkv(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """attn.{q,k,v} -> mixer.Wqkv, attn.qkv -> mixer.Wqkv, attn.proj ->
    mixer.out_proj (prefix-preserving, any block depth)."""
    out = dict(sd)
    for qk in [k for k in sd if re.search(r"\.attn\.q\.weight$", k)]:
        prefix = qk[: -len("q.weight")]
        fused = prefix.replace(".attn.", ".mixer.")[:-1] + ".Wqkv."
        out[fused + "weight"] = np.concatenate(
            [out.pop(prefix + f"{n}.weight") for n in "qkv"])
        if prefix + "q.bias" in out:
            out[fused + "bias"] = np.concatenate(
                [out.pop(prefix + f"{n}.bias") for n in "qkv"])
    renames = {}
    for k in out:
        if ".attn.qkv." in k:
            renames[k] = k.replace(".attn.qkv.", ".mixer.Wqkv.")
        elif ".attn.proj." in k:
            renames[k] = k.replace(".attn.proj.", ".mixer.out_proj.")
    for old, new in renames.items():
        out[new] = out.pop(old)
    return out


# ------------------------------------------------- pos-embed interpolation

def _interp_spatial(arr: np.ndarray, new_l: int, n_extra: int) -> np.ndarray:
    """[1, extra + H*W, D] -> [1, extra + H'*W', D], torch-bicubic."""
    d = arr.shape[-1]
    old_g = int(round((arr.shape[1] - n_extra) ** 0.5))
    new_g = int(round(new_l ** 0.5))
    if old_g == new_g:
        return arr
    extra = arr[:, :n_extra]
    grid = arr[:, n_extra:].reshape(1, old_g, old_g, d)
    m = _interp_matrix_1d(old_g, new_g, "cubic").astype(arr.dtype)
    grid = np.einsum("Hh,bhwd->bHwd", m, grid)
    grid = np.einsum("Ww,bhwd->bhWd", m, grid)
    return np.concatenate([extra, grid.reshape(1, new_g * new_g, d)], axis=1)


def _interp_temporal(arr: np.ndarray, new_t: int, mode: str) -> np.ndarray:
    """[1, T, D] -> [1, T', D], linear or (shrinking) middle-crop."""
    old_t = arr.shape[1]
    if old_t == new_t:
        return arr
    if old_t > new_t and mode == "crop":
        start = (old_t - new_t) // 2
        return arr[:, start: start + new_t]
    m = _interp_matrix_1d(old_t, new_t, "linear").astype(arr.dtype)
    return np.einsum("Tt,btd->bTd", m, arr)


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def convert_retfound_2d_state_dict(
        sd: Mapping, t_patch_size: int, target_grid: int,
        duplicate_high_res: bool = True) -> dict[str, np.ndarray]:
    """RETFound / ImageNet-MAE 2D checkpoint -> joint-res 3D MAE layout
    (the reference's resume_type='retfound_2_flash_attn'):

    - pos_embed [1, 1 + g*g, D] -> pos_embed_class + pos_embed_spatial,
      bicubic g x g -> ``target_grid`` (and the decoder's likewise);
    - the Conv2d patch embed [D, C, p, p] -> Conv3d [D, C, t, p, p],
      repeated over t and divided by t;
    - optionally duplicated into high_res_patch_embed.

    pos_embed_temporal and the params a 2D checkpoint lacks keep the
    model's init (``import_state_dict`` reports them missing)."""
    out = {k: _numpy(v) for k, v in sd.items()}
    for prefix in ("", "decoder_"):
        key = f"{prefix}pos_embed"
        if key in out:
            pe = out.pop(key)
            out[f"{prefix}pos_embed_class"] = pe[:, :1]
            out[f"{prefix}pos_embed_spatial"] = _interp_spatial(
                pe[:, 1:], target_grid ** 2, 0)
    w2d = out.get("patch_embed.proj.weight")
    if w2d is not None and w2d.ndim == 4:
        w3d = np.repeat(w2d[:, :, None], t_patch_size, axis=2) / t_patch_size
        out["patch_embed.proj.weight"] = w3d
        if duplicate_high_res:
            out["high_res_patch_embed.proj.weight"] = w3d
            if "patch_embed.proj.bias" in out:
                out["high_res_patch_embed.proj.bias"] = out[
                    "patch_embed.proj.bias"]
    return out


def import_state_dict(
        template: nn.Module | Mapping[str, torch.Tensor],
        state_dict: Mapping, *, strict: bool = True,
        drop_keys: tuple[str, ...] = (),
        smaller_interpolate_type: str = "interp",
) -> tuple[dict[str, torch.Tensor], dict[str, list[str]]]:
    """Merge a reference state dict into a model's own weights.

    ``template``: the model or its state dict (its init fills what the
    file lacks); ``state_dict``: {reference key: tensor or array}.
    ``drop_keys``: substrings of keys to skip (the reference's filter_keys,
    e.g. ('head',) for a new task).  Pos embeds whose shape differs are
    interpolated; any other shape mismatch raises.

    -> ({key: tensor} for every template key, fp32 CPU tensors for the
    loaded ones and the template's own for the rest; {"missing": template
    keys not in the file, "unexpected": file keys with no slot}).
    Unexpected keys raise only when ``strict``."""
    if isinstance(template, nn.Module):
        template = template.state_dict()
    sd = _fuse_qkv({k: _numpy(v) for k, v in state_dict.items()
                    if not any(s in k for s in drop_keys)})
    merged: dict[str, torch.Tensor] = {}
    unexpected = []
    for key, arr in sd.items():
        if key not in template:
            unexpected.append(key)
            continue
        shape = tuple(template[key].shape)
        if arr.shape != shape:
            if "pos_embed_temporal" in key:
                arr = _interp_temporal(arr, shape[1], smaller_interpolate_type)
            elif "pos_embed" in key:
                # a flat pos_embed carries its cls rows before the grid
                n_extra = (0 if "pos_embed_spatial" in key else
                           arr.shape[1] - int(round(arr.shape[1] ** 0.5)) ** 2)
                arr = _interp_spatial(arr, shape[1] - n_extra, n_extra)
            if arr.shape != shape:
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs model {shape}")
        merged[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    missing = [k for k in template if k not in merged]
    if strict and unexpected:
        raise ValueError(f"unexpected checkpoint keys: {unexpected}")
    for k in missing:
        merged[k] = template[k]
    return ({k: merged[k] for k in template},
            {"missing": missing, "unexpected": unexpected})


def load_reference_weights(model: nn.Module, state_dict: Mapping, *,
                           strict: bool = True,
                           drop_keys: tuple[str, ...] = ()) -> dict:
    """``import_state_dict`` into ``model`` in place -> its report."""
    merged, report = import_state_dict(model, state_dict, strict=strict,
                                       drop_keys=drop_keys)
    model.load_state_dict(merged, strict=True)
    return report


def build_model(ctor, init_params, device, seed: int, state_dict,
                **kw) -> nn.Module:
    """``ctor(**kw)`` built on the meta device (so no throw-away default
    initialisation runs), materialised on ``device``, given
    ``init_params(model, generator)`` from a generator seeded ``seed``,
    then ``state_dict`` imported over that init: params the file lacks
    keep it, with a warning that names them; keys with no slot raise."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = ctor(**kw)
    model.to_empty(device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(seed))
    if state_dict is not None:
        report = load_reference_weights(model, state_dict)
        if report["missing"]:
            warnings.warn(f"missing params filled from init: "
                          f"{report['missing']}", stacklevel=3)
    return model
