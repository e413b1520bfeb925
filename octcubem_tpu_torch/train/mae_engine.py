"""MAE pretraining steps (counterpart of octcubem_tpu/train/mae_engine.py).

One step is the JAX step run eagerly: the MAE loss on a 3D batch (plus,
when ``joint``, the loss on a 2D high-res batch, summed), its gradient,
one AdamW update and the metrics.  bf16 activations, fp32 params and
optimizer; no loss scaler.  On the card every attention call runs kernel
B1 forward and B2 backward.

The masking noise is drawn from ``state.generator`` unless the caller
passes it: ``noise`` is then the noise tensors [B, L] in the order the
step draws them, one per forward (the 3D batch, then the 2D batch when
``joint``; microbatch by microbatch with ``accum_iter``).  A single
tensor stands for a one-element list.  The parity tests pass the JAX
package's noise this way.
"""

from __future__ import annotations

import torch

from .optim import global_norm
from .train_state import TrainState


def make_mae_train_step(model, tx, joint: bool = False,
                        use_premask: bool = False, accum_iter: int = 1,
                        compute_grad_norm: bool = True, model2d=None,
                        accum_2d: int = 1):
    """-> step(state, batch3d, mask_ratio=0.9, batch2d=None,
    mask_ratio_2d=0.75, noise=None) -> (state, metrics).

    ``accum_iter`` > 1: batches carry leading dims [accum_iter, micro,
    ...]; the microbatch gradients are averaged into one update (each
    micro-loss is a mean over its microbatch, so the average is the
    effective-batch gradient).  Metrics: loss, loss_3d, loss_2d (0 unless
    joint), frame_losses [B, t] and grad_norm (the global norm of the
    averaged gradient, or 0 when ``compute_grad_norm`` is False); 0-d
    tensors on the model's device, read without a host sync."""
    if use_premask:
        raise NotImplementedError("the in-step blank-region pre-mask "
                                  "(data/premask.py) is not ported yet "
                                  "(ROADMAP A6)")
    if model2d is not None or accum_2d != 1:
        raise NotImplementedError("model2d and accum_2d are not ported yet "
                                  "(ROADMAP A8)")
    if accum_iter < 1:
        raise ValueError("accum_iter must be >= 1")

    def step(state: TrainState, batch3d, mask_ratio: float = 0.9,
             batch2d=None, mask_ratio_2d: float = 0.75, noise=None):
        if joint and batch2d is None:
            raise ValueError("a joint step needs batch2d")
        given = ([noise] if isinstance(noise, torch.Tensor)
                 else None if noise is None else list(noise))

        def draw(x):
            if given is not None:
                if not given:
                    raise ValueError("fewer noise tensors than forwards")
                return given.pop(0)
            return torch.rand((x.shape[0], model.num_tokens(x)),
                              generator=state.generator, device=x.device)

        model.train()
        params = list(model.parameters())
        grads = None
        if accum_iter == 1:
            micro = [(batch3d, batch2d)]
        else:
            micro = [(batch3d[i], batch2d[i] if joint else None)
                     for i in range(accum_iter)]
        zero = torch.zeros((), device=batch3d.device)
        l3_sum, l2_sum, fls = zero, zero, []
        for b3, b2 in micro:
            loss3d, fl, _, _ = model(b3, mask_ratio, draw(b3),
                                     generator=state.generator)
            total, loss2d = loss3d, zero
            if joint:
                loss2d = model(b2, mask_ratio_2d, draw(b2),
                               generator=state.generator)[0]
                total = total + loss2d
            # summed out of place: autograd may hand two params views of one
            # gradient buffer (cls_token and pos_embed_class at batch 1),
            # which an in-place accumulation into .grad would add twice
            g = torch.autograd.grad(total / accum_iter, params,
                                    allow_unused=True)
            grads = g if grads is None else [
                b if a is None else a if b is None else a + b
                for a, b in zip(grads, g)]
            l3_sum = l3_sum + loss3d.detach()
            l2_sum = l2_sum + loss2d.detach()
            fls.append(fl.detach())
        if given:
            raise ValueError(f"{len(given)} noise tensors left unused")
        for p, g in zip(params, grads):
            p.grad = g
        gn = (global_norm([g if g is not None else torch.zeros_like(p)
                           for p, g in zip(params, grads)])
              if compute_grad_norm else zero)
        tx.step()
        state.step += 1
        l3, l2 = l3_sum / accum_iter, l2_sum / accum_iter
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
