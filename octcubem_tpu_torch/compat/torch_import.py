"""Read reference PyTorch checkpoints (counterpart of
octcubem_tpu/compat/torch_import.py, flash layout only).

The port's modules use the reference flash-attn layout, so a flash
checkpoint loads with ``load_state_dict(strict=True)`` and no converter.
The other reference layouts (split q/k/v, RETFound fused qkv, 2D
weights, pos-embed interpolation) are not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import torch

_OTHER_LAYOUTS = (".attn.q.", ".attn.k.", ".attn.v.", ".attn.qkv.",
                  ".attn.proj.")


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A flash-layout .pth -> {key: fp32 tensor} on the CPU.  Unwraps
    {'model': ...} and drops 'module.' prefixes; raises on any other
    key layout."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and isinstance(ckpt.get("model"), dict):
        ckpt = ckpt["model"]
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
