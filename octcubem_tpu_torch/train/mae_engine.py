"""MAE pretraining steps (counterpart of octcubem_tpu/train/mae_engine.py).

One step is the JAX step run eagerly: the MAE loss on a 3D batch (plus,
when ``joint``, the loss on a 2D high-res batch, summed), its gradient,
one AdamW update and the metrics.  bf16 activations, fp32 params and
optimizer; no loss scaler.  On the card every attention call runs kernel
B1 forward and B2 backward.

The options, as in JAX:
- ``use_premask``: the blank-region pre-mask (``data/premask.py``) is
  computed inside the step from the 3D batch's patch embeddings, with no
  gradient, for each 3D forward; an explicit ``pre_mask=`` is used as
  given instead (not with ``accum_iter`` > 1).
- ``accum_iter`` > 1: batches carry [accum_iter, micro, ...]; the
  microbatch gradients are averaged into one update.
- ``accum_2d`` > 1 (joint only, exclusive with ``accum_iter``): batch2d
  carries [accum_2d, micro, ...]; the 3D batch's gradient is taken whole,
  then g/K of each of the K 2D microbatches is added to it, and loss_2d
  is their mean (grads3d + mean_k grads2d_k, the fused joint gradient).
- ``model2d``: the module the 2D branch runs, over ``model``'s own
  parameter objects (``MaskedAutoencoderViT3D.with_remat``), so its
  gradient reaches the optimizer; anything else raises.

The masking noise is drawn from ``state.generator`` unless the caller
passes it: ``noise`` is then the noise tensors [B, L] in the order the
step draws them, one per forward: microbatch by microbatch with
``accum_iter`` (the 3D batch, then the 2D batch when ``joint``); with
``accum_2d`` the 3D batch, then the K 2D microbatches.  A single tensor
stands for a one-element list.  The parity tests pass the JAX package's
noise this way.
"""

from __future__ import annotations

import torch

from ..data.premask import compute_premask
from .optim import global_norm
from .train_state import TrainState


def _accumulate(acc, grads, divisor: int = 1):
    """acc + grads / divisor per leaf, out of place (None = no gradient).
    Out of place because autograd may hand two params views of one
    gradient buffer (cls_token and pos_embed_class at batch 1), which an
    in-place accumulation would add twice."""
    if divisor != 1:
        grads = [None if g is None else g / divisor for g in grads]
    if acc is None:
        return list(grads)
    return [b if a is None else a if b is None else a + b
            for a, b in zip(acc, grads)]


def make_mae_train_step(model, tx, joint: bool = False,
                        use_premask: bool = False, accum_iter: int = 1,
                        compute_grad_norm: bool = True, model2d=None,
                        accum_2d: int = 1):
    """-> step(state, batch3d, mask_ratio=0.9, batch2d=None,
    mask_ratio_2d=0.75, pre_mask=None, noise=None) -> (state, metrics).

    Metrics: loss, loss_3d, loss_2d (0 unless joint), frame_losses [B, t]
    and grad_norm (the global norm of the applied gradient, or 0 when
    ``compute_grad_norm`` is False); 0-d tensors on the model's device,
    read without a host sync."""
    if accum_iter < 1 or accum_2d < 1:
        raise ValueError("accum_iter and accum_2d must be >= 1")
    if accum_iter > 1 and accum_2d != 1:
        raise ValueError("accum_iter and accum_2d are exclusive")
    if accum_2d > 1 and not joint:
        raise ValueError(
            "accum_2d microbatches the 2D branch of a joint step")
    params = list(model.parameters())
    if model2d is not None:
        shared = list(model2d.parameters())
        if len(shared) != len(params) or any(
                a is not b for a, b in zip(params, shared)):
            raise ValueError("model2d must run over model's own parameter "
                             "objects (MaskedAutoencoderViT3D.with_remat)")
    m2d = model2d if model2d is not None else model

    def step(state: TrainState, batch3d, mask_ratio: float = 0.9,
             batch2d=None, mask_ratio_2d: float = 0.75, pre_mask=None,
             noise=None):
        if joint and batch2d is None:
            raise ValueError("a joint step needs batch2d")
        if pre_mask is not None and accum_iter > 1:
            raise ValueError("pass use_premask=True with accum_iter>1")
        given = ([noise] if isinstance(noise, torch.Tensor)
                 else None if noise is None else list(noise))

        def draw(x):
            if given is not None:
                if not given:
                    raise ValueError("fewer noise tensors than forwards")
                return given.pop(0)
            return torch.rand((x.shape[0], model.num_tokens(x)),
                              generator=state.generator, device=x.device)

        def loss3d(x):
            pm = pre_mask
            if use_premask and pm is None:
                with torch.no_grad():
                    feat = model.forward_patch_embed(x)
                pm = compute_premask(feat, model.t_grid, model.grid)
            loss, fl, _, _ = model(x, mask_ratio, draw(x), pre_mask=pm,
                                   generator=state.generator)
            return loss, fl

        def loss2d(x):
            return m2d(x, mask_ratio_2d, draw(x),
                       generator=state.generator)[0]

        model.train()
        m2d.train()
        zero = torch.zeros((), device=batch3d.device)
        if accum_2d > 1:
            l3, fl = loss3d(batch3d)
            grads = _accumulate(None, torch.autograd.grad(
                l3, params, allow_unused=True))
            l2_sum = zero
            for k in range(accum_2d):
                l2 = loss2d(batch2d[k])
                grads = _accumulate(grads, torch.autograd.grad(
                    l2, params, allow_unused=True), accum_2d)
                l2_sum = l2_sum + l2.detach()
            l3, l2, fls = l3.detach(), l2_sum / accum_2d, [fl.detach()]
        else:
            if accum_iter == 1:
                micro = [(batch3d, batch2d)]
            else:
                micro = [(batch3d[i], batch2d[i] if joint else None)
                         for i in range(accum_iter)]
            grads, l3_sum, l2_sum, fls = None, zero, zero, []
            for b3, b2 in micro:
                l3, fl = loss3d(b3)
                total, l2 = l3, zero
                if joint:
                    l2 = loss2d(b2)
                    total = total + l2
                grads = _accumulate(grads, torch.autograd.grad(
                    total / accum_iter, params, allow_unused=True))
                l3_sum = l3_sum + l3.detach()
                l2_sum = l2_sum + l2.detach()
                fls.append(fl.detach())
            l3, l2 = l3_sum / accum_iter, l2_sum / accum_iter
        if given:
            raise ValueError(f"{len(given)} noise tensors left unused")
        for p, g in zip(params, grads):
            p.grad = g
        gn = (global_norm([g if g is not None else torch.zeros_like(p)
                           for p, g in zip(params, grads)])
              if compute_grad_norm else zero)
        tx.step()
        state.step += 1
        metrics = {"loss": l3 + l2, "loss_3d": l3, "loss_2d": l2,
                   "frame_losses": torch.cat(fls, dim=0), "grad_norm": gn}
        return state, metrics

    return step


def make_mae_eval_step(model):
    """-> eval_step(batch, noise=None, generator=None) -> {loss,
    frame_losses, pred, mask} at mask ratio 0.75 in eval mode, with no
    gradient; the noise is drawn from ``generator`` unless given."""

    @torch.no_grad()
    def eval_step(batch, noise=None, generator: torch.Generator | None = None):
        if noise is None:
            noise = torch.rand((batch.shape[0], model.num_tokens(batch)),
                               generator=generator, device=batch.device)
        model.eval()
        loss, frame_losses, pred, mask = model(batch, 0.75, noise)
        return {"loss": loss, "frame_losses": frame_losses, "pred": pred,
                "mask": mask}

    return eval_step
