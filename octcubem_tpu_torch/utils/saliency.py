"""Grad-CAM saliency for the ViT classifiers (counterpart of
octcubem_tpu/utils/saliency.py).

The JAX package takes activation gradients from flax perturbations; the
port builds the model with ``capture_cam=True``, whose
``TransformerStack`` adds a zero tensor that requires grad after every
block and keeps the activation (nn/layers.py).  One forward under
autograd (B1 through ``FlashPackedQKV``) gives the logits and the
activations; one ``torch.autograd.grad`` of the score with respect to
the chosen block's zero tensor gives dScore/dActivation, whatever the
parameters' ``requires_grad``.  Only the blocks after the chosen one are
differentiated (B2 once for each): at ``layer=-1`` with flash parity
the score reaches the last block's MLP branch through the pool and the
head alone, so no attention backward runs; at ``layer=0`` every block
but the first is differentiated.  The JAX function differentiates every
perturbation at once; the chosen layer's gradient is the same.
``clip_pair_gradcam`` does the same on one tower of a COEM model built
with ``capture_cam=True`` (both towers record their activations).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _cam_stack(model: torch.nn.Module):
    from ..nn.layers import TransformerStack

    stacks = [m for m in model.modules()
              if isinstance(m, TransformerStack) and m.capture_cam]
    if len(stacks) != 1:
        raise ValueError(f"gradcam needs a model built with capture_cam=True "
                         f"(one such TransformerStack), found {len(stacks)}")
    return stacks[0]


def gradcam(model: torch.nn.Module, x: torch.Tensor,
            score_fn: Callable | None = None, class_idx: int | None = None,
            layer: int = -1, grid: tuple[int, ...] | None = None
            ) -> np.ndarray:
    """Grad-CAM token saliency -> [B, L] (or [B, *grid]) in [0, 1].

    model: built with capture_cam=True (vit_st), in eval mode.
    score_fn(output) -> scalar; default: the sum of logits[:, class_idx],
      class_idx defaulting to the argmax of the batch-summed logits.
    layer: which block's activations (-1 = last).
    grid: (t, h, w) / (h, w) to reshape the token map; the cls token is
      dropped when the map holds one more token than the grid.

    The channel weights are the token mean of dScore/dA, the map
    ReLU(A . w), each sample divided by its max + 1e-8."""
    stack = _cam_stack(model)
    try:
        with torch.enable_grad():
            out = model(x)
            if isinstance(out, tuple):
                out = out[0]
            if score_fn is None:
                ci = class_idx
                if ci is None:
                    ci = int(torch.argmax(out.detach().sum(dim=0)))
                score_fn = lambda lg: lg[:, ci].sum()  # noqa: E731
            act, pert = stack.cam[layer]
            (g,) = torch.autograd.grad(score_fn(out), pert)
    finally:
        stack.cam = []

    w = g.float().mean(dim=1, keepdim=True)                   # [B, 1, D]
    cam = torch.clamp_min((act.detach().float() * w).sum(-1), 0)  # [B, N]
    if grid is not None:
        n = int(np.prod(grid))
        if cam.shape[1] == n + 1:
            cam = cam[:, 1:]
        cam = cam.reshape((cam.shape[0],) + tuple(grid))
    top = cam.amax(dim=tuple(range(1, cam.ndim)), keepdim=True)
    return (cam / (top + 1e-8)).cpu().numpy()


def clip_pair_gradcam(model: torch.nn.Module, image: torch.Tensor,
                      enface: torch.Tensor, target: str = "image",
                      layer: int = -1, grid: tuple[int, ...] | None = None
                      ) -> np.ndarray:
    """Saliency of the COEM pair similarity with respect to one tower's
    blocks, the retclip use (base_cam_retclip_3mod.py:21-303): which OCT
    or en face regions drive the match -> [B, L] (or [B, *grid]) in
    [0, 1].

    model: a 2-tower ``COEP2Tower`` built with capture_cam=True, in eval
      mode.  target: "image" (the OCT tower) or "enface".
    The map is |dSim/dA| over the channels at block ``layer`` of that
    tower, Sim the sum over the batch of the two normalized features'
    dot products, each sample divided by its max + 1e-8; the cls token is
    dropped as in ``gradcam``."""
    tower = model.visual if target == "image" else model.enface
    stack = _cam_stack(tower)
    other = _cam_stack(model.enface if target == "image" else model.visual)
    try:
        with torch.enable_grad():
            img_f, enf_f, _ = model(image, enface)
            _, pert = stack.cam[layer]
            (g,) = torch.autograd.grad((img_f * enf_f).sum(), pert)
    finally:
        stack.cam = []
        other.cam = []
    cam = torch.linalg.vector_norm(g.float(), dim=-1)
    if grid is not None:
        n = int(np.prod(grid))
        if cam.shape[1] == n + 1:
            cam = cam[:, 1:]
        cam = cam.reshape((cam.shape[0],) + tuple(grid))
    top = cam.amax(dim=tuple(range(1, cam.ndim)), keepdim=True)
    return (cam / (top + 1e-8)).cpu().numpy()
