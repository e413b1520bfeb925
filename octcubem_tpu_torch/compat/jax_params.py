"""Carry weights across: a flax param tree -> the port's state dict.

The port's own copy of the key and layout rules of the JAX package's
flash-layout exporter (``compat/torch_export.py``): blocks_i -> i,
Dense ``kernel`` [in, out] -> ``weight`` [out, in], LayerNorm ``scale``
-> ``weight``, the patch-embed ``kernel`` [t, p, p, C, D] -> Conv3d
``proj.weight`` [D, C, t, p, p], and SLIViT's ConvNeXt convolutions
(``stem_conv``, ``downsample_conv_*``, the depthwise ``dwconv``) ``kernel``
[kh, kw, Cin/groups, Cout] -> Conv2d ``weight`` [Cout, Cin/groups, kh, kw]
(a bare ``.T`` would swap kh and kw).  A quantized tree (the JAX package's
``ops.quant.quantize_tree``) maps too: a ``QuantDense``'s ``kernel_q``
int8 [in, out] -> ``weight_q`` int8 [out, in], its ``scale`` -> ``scale``
(ops/quant.py's layout).  Input leaves are numpy arrays (or anything
``np.asarray`` reads); no JAX is needed.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..ops.quant import QUANT_MODULES


def _flatten(tree: Any, prefix=()) -> dict[tuple, Any]:
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _is_conv(module: str) -> bool:
    """SLIViT's ConvNeXt convolutions (models/slivit.py)."""
    return (module in ("stem_conv", "dwconv")
            or module.startswith("downsample_conv_"))


def _to_torch_key(path: tuple[str, ...]) -> tuple[str, str]:
    """Flax param path -> (state-dict key, kind), kind in 'linear_w' |
    'linear_q' | 'conv_patch' | 'conv2d' | 'direct': the layout transform
    the value needs."""
    parts: list[str] = []
    kind = "direct"
    for p in path:
        if (p.startswith("blocks_") and p[len("blocks_"):].isdigit()
                and parts and parts[-1] in ("blocks", "decoder_blocks")):
            parts.append(p[len("blocks_"):])
            continue
        if p == "kernel":
            if len(path) >= 2 and path[-2].endswith("patch_embed"):
                parts.extend(("proj", "weight"))
                kind = "conv_patch"
            elif len(path) >= 2 and _is_conv(path[-2]):
                parts.append("weight")
                kind = "conv2d"
            else:
                parts.append("weight")
                kind = "linear_w"
            continue
        if p == "kernel_q":
            parts.append("weight_q")
            kind = "linear_q"
            continue
        if p == "scale":
            # a LayerNorm's scale is its weight; a QuantDense's stays scale
            quant = len(path) >= 2 and path[-2] in QUANT_MODULES
            parts.append("scale" if quant else "weight")
            continue
        if p == "bias" and len(path) >= 2 and path[-2].endswith("patch_embed"):
            parts.extend(("proj", "bias"))
            continue
        parts.append(p)
    return ".".join(parts), kind


def state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax params (with or without the 'params' root) -> {key: fp32
    torch.Tensor (int8 for ``weight_q``)} in the port's (reference flash)
    layout."""
    tree = params["params"] if "params" in params else params
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(dict(tree)).items():
        key, kind = _to_torch_key(path)
        arr = np.asarray(leaf, np.int8 if kind == "linear_q" else np.float32)
        if kind in ("linear_w", "linear_q"):
            arr = arr.T                          # [in, out] -> [out, in]
        elif kind == "conv2d":                   # [kh,kw,I,O] -> [O,I,kh,kw]
            arr = arr.transpose(3, 2, 0, 1)
        elif kind == "conv_patch":
            if arr.ndim == 5:                    # [t,p,p,C,D] -> [D,C,t,p,p]
                arr = arr.transpose(4, 3, 0, 1, 2)
            elif arr.ndim == 4:                  # [p,p,C,D] -> [D,C,p,p]
                arr = arr.transpose(3, 2, 0, 1)
            else:
                arr = arr.T
        out[key] = torch.from_numpy(np.array(arr, order="C"))
    return out
