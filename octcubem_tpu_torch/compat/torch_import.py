"""Read reference PyTorch checkpoints (counterpart of
octcubem_tpu/compat/torch_import.py, flash layout only).

The port's modules use the reference flash-attn layout, so a flash
checkpoint loads with ``load_state_dict(strict=True)`` and no converter.
The other reference layouts (split q/k/v, RETFound fused qkv, 2D
weights, pos-embed interpolation) are not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import argparse

import torch

_OTHER_LAYOUTS = (".attn.q.", ".attn.k.", ".attn.v.", ".attn.qkv.",
                  ".attn.proj.")
# the reference save paths' wrappers (OCTCube/util/misc.py, COEM's
# main_retclip.py), in the order the JAX loader tries them
_WRAPPERS = ("model", "state_dict", "model_state", "teacher")


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A flash-layout .pth -> {key: fp32 tensor} on the CPU.  Unwraps the
    first of 'model', 'state_dict', 'model_state' and 'teacher' that holds
    a dict (the JAX loader's order) and drops 'module.' prefixes; raises on
    any other key layout.  Loads with ``weights_only=True``, allowing the
    ``argparse.Namespace`` the reference saves under 'args'."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in _WRAPPERS:
        if isinstance(ckpt, dict) and isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
            break
    out = {}
    for k, v in ckpt.items():
        if not isinstance(v, torch.Tensor):
            continue
        k = k.removeprefix("module.")
        if any(s in k for s in _OTHER_LAYOUTS):
            raise ValueError(
                f"{path}: key {k!r} is not in the flash layout "
                "(blocks.i.mixer.Wqkv); converting other layouts is not "
                "ported yet (ROADMAP A9)")
        out[k] = v.float()
    return out
