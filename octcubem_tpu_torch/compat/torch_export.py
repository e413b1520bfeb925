"""Write reference PyTorch checkpoints (counterpart of
octcubem_tpu/compat/torch_export.py).

The port's modules already carry the reference names, so exporting is a
copy to fp32 CPU tensors in one of two layouts:

- 'flash' (default): ``blocks.i.mixer.Wqkv`` / ``mixer.out_proj``, the
  layout the reference's flash-attn models save and load;
- 'retfound': ``blocks.i.attn.qkv`` / ``attn.proj``, the timm / RETFound
  fused layout of the reference's non-flash models.

``save_torch_checkpoint`` writes ``{'model': state_dict, **extra}`` (the
reference's misc.save_model wrapping); ``cli/export.py`` puts the run's
geometry stamp under ``octcubem_tpu_geometry`` in ``extra``, the key the
JAX package writes and both packages check.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn


def export_state_dict(model: nn.Module | Mapping[str, torch.Tensor], *,
                      style: str = "flash") -> dict[str, torch.Tensor]:
    """A model (or its state dict) -> {reference key: fp32 CPU tensor} in
    the 'flash' or 'retfound' layout; every tensor is a copy."""
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    out = {k: v.detach().to("cpu", torch.float32, copy=True).contiguous()
           for k, v in sd.items()}
    if style == "retfound":
        return to_retfound_layout(out)
    if style != "flash":
        raise ValueError(f"unknown export style {style!r}")
    return out


def to_retfound_layout(sd: Mapping[str, Any]) -> dict[str, Any]:
    """flash layout -> the timm / RETFound fused-qkv layout
    (mixer.Wqkv -> attn.qkv, mixer.out_proj -> attn.proj)."""
    out = {}
    for k, v in sd.items():
        if ".mixer.Wqkv." in k:
            k = k.replace(".mixer.Wqkv.", ".attn.qkv.")
        elif ".mixer.out_proj." in k:
            k = k.replace(".mixer.out_proj.", ".attn.proj.")
        out[k] = v
    return out


def save_torch_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                          extra: Mapping[str, Any] | None = None) -> None:
    """Write a reference-loadable .pth: {'model': state_dict, **extra}."""
    payload: dict[str, Any] = {"model": dict(state_dict)}
    if extra:
        payload.update(extra)
    torch.save(payload, path)
