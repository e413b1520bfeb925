"""Carry weights across: a flax param tree -> the port's state dict.

The port's own copy of the key and layout rules of the JAX package's
flash-layout exporter (``compat/torch_export.py``): blocks_i -> i,
Dense ``kernel`` [in, out] -> ``weight`` [out, in], LayerNorm ``scale``
-> ``weight``, the patch-embed ``kernel`` [t, p, p, C, D] -> Conv3d
``proj.weight`` [D, C, t, p, p], and every other 4-D ``kernel``, an
``nn.Conv``'s [kh, kw, Cin/groups, Cout] (SLIViT's ConvNeXt,
models/slivit.py; the aux towers', models/aux_towers.py) -> Conv2d
``weight`` [Cout, Cin/groups, kh, kw] (a bare ``.T`` would swap kh and
kw).  An ``nn.Embed``'s ``embedding`` -> ``weight``; a variables dict's
``batch_stats`` (BatchNorm ``mean`` / ``var``) -> ``running_mean`` /
``running_var``.  A Flax BERT tree (the HuggingFace text tower) maps by
the same rules onto the torch BERT state dict (``layer/0`` ->
``layer.0``).  A quantized tree (the JAX package's
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


def _is_conv(kernel) -> bool:
    """An ``nn.Conv`` kernel [kh, kw, I / groups, O]: 4-D, where every
    Dense kernel is 2-D (SLIViT's ConvNeXt, the aux towers' convs)."""
    return np.ndim(kernel) == 4


def _to_torch_key(path: tuple[str, ...]) -> tuple[str, str]:
    """Flax param path -> (state-dict key, kind), kind in 'linear_w' |
    'linear_q' | 'conv_patch' | 'direct': the layout transform the value
    needs ('linear_w' on a conv's 4-D kernel is 'conv2d', which the
    value's shape decides)."""
    parts: list[str] = []
    kind = "direct"
    for p in path:
        if (p.startswith("blocks_") and p[len("blocks_"):].isdigit()
                and parts and parts[-1] in ("blocks", "decoder_blocks")):
            parts.append(p[len("blocks_"):])
            continue
        if p == "embedding":
            parts.append("weight")
            continue
        if p == "kernel":
            if len(path) >= 2 and path[-2].endswith("patch_embed"):
                parts.extend(("proj", "weight"))
                kind = "conv_patch"
            else:  # a Dense kernel, or a conv's (state_dict_from_jax)
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


_STATS = {"mean": "running_mean", "var": "running_var"}


def state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax params (with or without the 'params' root; a variables dict
    may also hold 'batch_stats') -> {key: fp32 torch.Tensor (int8 for
    ``weight_q``)} in the port's (reference flash) layout."""
    tree = params["params"] if "params" in params else params
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(dict(params.get("batch_stats", {}))).items():
        key, _ = _to_torch_key(path[:-1])
        out[f"{key}.{_STATS[path[-1]]}"] = torch.from_numpy(
            np.array(leaf, np.float32))
    for path, leaf in _flatten(dict(tree)).items():
        key, kind = _to_torch_key(path)
        arr = np.asarray(leaf, np.int8 if kind == "linear_q" else np.float32)
        if kind == "linear_w" and _is_conv(arr):
            kind = "conv2d"
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
