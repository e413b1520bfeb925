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

Data parallelism (``mesh``, a ``core/mesh`` DeviceMesh spanning the
group).  A rank is JAX's host: the batch it is given is its rows of the
global batch (``shard_batch`` / ``shard_microbatch``; ranks of one data
index, along ``fsdp`` or ``sp``, hold the same rows).  The step reduces
its gradient list explicitly, the mean over every rank of the mesh in
flat buckets (``core/multihost.all_reduce_mean``), before the global
norm and AdamW; ``DistributedDataParallel``'s hooks would never fire
under ``torch.autograd.grad``.  The losses it returns are reduced the same
way, so every rank logs JAX's global loss; ``frame_losses`` stay this
rank's rows (JAX's ``local_rows``).  The mean of the ranks' means is the
global mean because every rank's loss is a mean over equal counts: the
same number of masked patches per sample at one mask ratio, pre-mask or
not, in both branches.  The masking noise is JAX's global draw: each
rank keeps its rows of one (B_global, L) draw from the replicated
generator, so the generators stay in lockstep and an n-rank step equals
a one-rank step on the global batch.  Under ``n_sp`` > 1 the stacks
shard and gather the tokens (parallel/sequence.py); the same mean over
every rank is then the exact gradient.

A state sharded over the mesh's ``fsdp`` axis (``core/fsdp.shard_state``,
JAX's ``put_tree(mesh, state, fsdp_param_spec)``) trains through the same
step: its forwards and backwards run inside ``fsdp.gathered``, where each
sharded param reads as its whole tensor, gathered once per step (the
3D batch, the 2D batch, every microbatch and ``model2d``'s remat
recompute all read it), and its chunk's gradient comes back
reduce-scattered; ``fsdp.mean_grads`` takes the mean over the mesh and
``grad_norm`` the global gradient's norm, and AdamW updates each rank's
chunks.

On the card the step replays one captured CUDA graph of itself
(``train/step_graph.py``): each key of the inputs' shapes, the mask
ratios and whether noise is given runs its first call eagerly, its
second captured, and every later one as a replay.  That holds with no
mesh, on one rank, and on a mesh of several ranks joined by NCCL with
no ``sp`` axis, where the gradient's and the losses' all-reduces are
captured inside the graph; gloo ranks, an ``sp`` mesh, a sharded
state, the CPU, a step that a profiler records and a model that
checkpoints a block with drop path run eagerly.

Each call is one ``utils/profiling.step("mae")`` whose ``path`` says how
it ran.  An eager, warm-up or capture step has the phases ``forward``
(every loss3d / loss2d call, with its noise draw and pre-mask; inside
it ``premask``, the pre-mask's patch embedding and ``compute_premask``,
where the step computes one, and ``branch2d``, each 2D forward of a
joint step), ``backward`` (every ``autograd.grad``; with ``accum_2d`` 1
the 2D loss is differentiated with the 3D one, so the 2D backward has
no phase of its own) and ``update`` (``reduce``, where the step reduces:
the gradient mean and the loss all-reduce; the norm; ``adamw``); a
replay has the one phase ``replay``.
"""

from __future__ import annotations

import torch

from ..core import fsdp, multihost
from ..core.mesh import DATA_AXIS, axis_coord, check_mesh
from ..data.premask import compute_premask
from ..utils import profiling
from . import step_graph
from .optim import grad_norm
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


def _grad(loss, params):
    """The gradient of ``loss`` over ``params``, in the step's backward
    phase."""
    with profiling.phase("backward", span=False):
        return torch.autograd.grad(profiling.backward(loss), params,
                                   allow_unused=True)


def make_mae_train_step(model, tx, joint: bool = False,
                        use_premask: bool = False, accum_iter: int = 1,
                        model2d=None, accum_2d: int = 1, mesh=None):
    """-> step(state, batch3d, mask_ratio=0.9, batch2d=None,
    mask_ratio_2d=0.75, pre_mask=None, noise=None) -> (state, metrics).

    Metrics: loss, loss_3d, loss_2d (0 unless joint), frame_losses [B, t]
    and grad_norm (the global norm of the applied gradient); 0-d tensors
    on the model's device, read without a host sync.  ``mesh``: the
    data-parallel mesh (module docstring); None runs on this rank alone.
    ``step.graphs`` is the step's ``step_graph.StepGraphs``."""
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
    d_idx, n_d = axis_coord(mesh, DATA_AXIS)
    reduce = check_mesh(mesh)
    graphs = step_graph.StepGraphs(params)
    capturable = step_graph.capturable(model, m2d)

    def step(state: TrainState, batch3d, mask_ratio: float = 0.9,
             batch2d=None, mask_ratio_2d: float = 0.75, pre_mask=None,
             noise=None):
        with profiling.step("mae") as rec:
            batch3d = multihost.local(batch3d)
            inputs = {"batch3d": batch3d, "batch2d": multihost.local(batch2d),
                      "pre_mask": pre_mask, "noise": noise}

            def run(state, x):
                return body(state, mask_ratio=mask_ratio,
                            mask_ratio_2d=mask_ratio_2d, **x)

            if not (capturable and step_graph.engages(
                    batch3d.device, mesh, state.shards)):
                return run(state, inputs)
            key = (mask_ratio, mask_ratio_2d, step_graph.signature(inputs))
            return graphs(rec, key, run, state, inputs)

    step.graphs = graphs

    def body(state, batch3d, mask_ratio, batch2d, mask_ratio_2d, pre_mask,
             noise):
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
            rows = x.shape[0]
            noise = torch.rand((rows * n_d, model.num_tokens(x)),
                               generator=state.generator, device=x.device)
            return noise[d_idx * rows:(d_idx + 1) * rows]

        def loss3d(x):
            with profiling.phase("forward"):
                pm = pre_mask
                if use_premask and pm is None:
                    with profiling.phase("premask"), torch.no_grad():
                        feat = model.forward_patch_embed(x)
                        pm = compute_premask(feat, model.t_grid, model.grid)
                loss, fl, _, _ = model(x, mask_ratio, draw(x), pre_mask=pm,
                                       generator=state.generator)
                return loss, fl

        def loss2d(x):
            with profiling.phase("forward"), profiling.phase("branch2d"):
                return m2d(x, mask_ratio_2d, draw(x),
                           generator=state.generator)[0]

        model.train()
        m2d.train()
        with fsdp.gathered(state, mesh):
            grads, l3, l2, fls = fwd_bwd(batch3d, batch2d, loss3d, loss2d)
        if given:
            raise ValueError(f"{len(given)} noise tensors left unused")
        with profiling.phase("update"):
            with profiling.phase("reduce",
                                 on=reduce or state.shards is not None):
                grads = fsdp.mean_grads(state, params, grads, reduce)
                if reduce:
                    l3, l2 = multihost.all_reduce_mean(
                        [torch.stack([l3, l2])])[0].unbind(0)
            for p, g in zip(params, grads):
                p.grad = g
            gn = grad_norm(params, grads, state.shards)
            tx.step()
            state.step += 1
        metrics = {"loss": l3 + l2, "loss_3d": l3, "loss_2d": l2,
                   "frame_losses": torch.cat(fls, dim=0), "grad_norm": gn}
        return state, metrics

    def fwd_bwd(batch3d, batch2d, loss3d, loss2d):
        """The step's losses and gradient list, before any reduction."""
        zero = torch.zeros((), device=batch3d.device)
        if accum_2d > 1:
            l3, fl = loss3d(batch3d)
            grads = _accumulate(None, _grad(l3, params))
            l2_sum = zero
            for k in range(accum_2d):
                l2 = loss2d(batch2d[k])
                grads = _accumulate(grads, _grad(l2, params), accum_2d)
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
                grads = _accumulate(grads, _grad(total / accum_iter,
                                                 params))
                l3_sum = l3_sum + l3.detach()
                l2_sum = l2_sum + l2.detach()
                fls.append(fl.detach())
            l3, l2 = l3_sum / accum_iter, l2_sum / accum_iter
        return grads, l3, l2, fls

    return step


def shard_batch(batch, mesh):
    """This rank's rows of the global batch as the data-sharded global
    ``DTensor`` (``core/multihost.global_batch``; a dict or tuple of them
    leaf by leaf); the steps compute on its local tensor.  No mesh: the
    batch as it is."""
    if mesh is None:
        return batch
    return multihost.map_tree(
        lambda _, x: multihost.global_batch(mesh, x, DATA_AXIS), batch)


def shard_microbatch(batch, mesh):
    """An [accum, micro, ...] batch with the MICRO axis sharded over the
    data axis (accumulation chunks stay whole per rank): dim 1 is this
    rank's micro shard."""
    if mesh is None:
        return batch
    return multihost.map_tree(
        lambda _, x: multihost.global_batch(mesh, x, DATA_AXIS,
                                            micro_axis=True), batch)


def replicate_state(state: TrainState, mesh):
    """Every rank's params, buffers and optimizer moments set to rank 0's
    (a broadcast, as ``DistributedDataParallel`` starts), in place; the
    generators are seeded alike.  No mesh: the state as it is.
    ``core/fsdp.shard_state`` shards a state over the mesh instead."""
    if mesh is None or multihost.world()[1] == 1:
        return state
    tx = state.tx
    multihost.broadcast_(list(state.params.parameters())
                         + list(state.params.buffers())
                         + list(getattr(tx, "mu", [])) + list(
                             getattr(tx, "nu", [])))
    return state


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
