"""Head-parallel (tensor-parallel) attention over ``torch.distributed``
(counterpart of octcubem_tpu/parallel/tensor.py).

Attention heads are independent, so the packed [B, N, H*D] layout
shards its minor dim by head groups over a ``tp`` axis of a
``DeviceMesh``: each rank runs the flash kernels (B1 forward, B2
backward) on its own heads with no collective inside the attention.  The
JAX package sees global arrays under GSPMD; a rank here holds its shard,
so the projections around the attention are written out in the Megatron
form (``nn/layers.py``, ``attn_impl="flash_tp"``):

- ``mixer.Wqkv`` and ``mlp.fc1`` are column-parallel: their input passes
  ``copy_to_tp`` (identity forward, all-reduce backward) and each rank
  holds the output rows of its heads (of its hidden units);
- ``mixer.out_proj`` and ``mlp.fc2`` are row-parallel: each rank holds
  the input columns of its heads, its partial product passes
  ``reduce_from_tp`` (all-reduce forward, identity backward) and the bias
  is added once, after the sum.

``shard_tp_params`` leaves each rank its shard of the reference-layout
weights (``blocks.N.mixer.Wqkv.weight``, ``[out, in]``).  The fused
``Wqkv`` is not split contiguously, which would leave rank 0 only q
rows: rank r keeps the rows of its heads in each of q, k and v, so its
local ``[3 * H/n_tp * D, dim]`` weight yields the rank's own fused
buffer.  ``gather_tp_state_dict`` undoes the split (export, and gradient
comparisons on full tensors).  ``tp_param_spec`` is JAX's placement
annotation, leaf for leaf: the split ``shard_tp_params`` makes inside
the fused weight is the head layout GSPMD reaches by resharding.

Parameters other than the four projections are replicated; the
all-reduce in ``copy_to_tp``'s backward hands every rank the full
gradient of the replicated activations, so their gradients need no
further reduction over ``tp``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..core.multihost import all_reduce_sum

COLUMN = ("Wqkv", "fc1")
ROW = ("out_proj", "fc2")


def _tp_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def head_parallel_attention(q, k, v, num_heads: int, mesh, axis: str = "tp",
                            scale=None):
    """q, k, v: this rank's head group [B, N, (H / n_tp) * D] of the
    packed layout -> its output shard, the same shape.  ``num_heads`` is
    the global H.  Differentiable and collective-free in both directions:
    the rank's heads go through ``flash_attention_packed`` (B1 / B2 on the
    card, their plain versions on the CPU)."""
    from ..ops.flash_attention import flash_attention_packed

    n_tp = _tp_size(mesh, axis)
    if num_heads % n_tp:
        raise ValueError(f"{num_heads} heads do not split over {n_tp} "
                         f"ranks of {axis!r}")
    return flash_attention_packed(q, k, v, num_heads // n_tp, scale=scale)


def tp_param_spec(name: str, tensor, axis: str = "tp") -> tuple:
    """JAX's placement of a transformer param under head parallelism, on
    the port's ``[out, in]`` weights: Wqkv / fc1 weights column-sharded
    (their output dim), out_proj / fc2 weights row-sharded (their input
    dim), everything else (biases included) replicated."""
    parts = name.split(".")
    if getattr(tensor, "ndim", 0) != 2 or parts[-1] != "weight":
        return ()
    if any(p in COLUMN for p in parts):
        return (axis, None)
    if any(p in ROW for p in parts):
        return (None, axis)
    return ()


# ---- the column / row collectives

class _CopyToTP(torch.autograd.Function):
    """Identity forward; all-reduce (sum) of the gradient backward: the
    input of a column-parallel projection."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward: the output of a
    row-parallel projection."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x, group):
    if dist.get_world_size(group) == 1:
        return x
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x, group):
    if dist.get_world_size(group) == 1:
        return x
    return _ReduceFromTP.apply(x, group)


# ---- model integration: attn_impl="flash_tp" (the context pattern of
# parallel.sequence.use_sequence_parallel)

_TP_CONTEXT: list[tuple] = []


@contextlib.contextmanager
def use_tensor_parallel(mesh, axis: str = "tp"):
    _TP_CONTEXT.append((mesh, axis))
    try:
        yield
    finally:
        _TP_CONTEXT.pop()


def current_tp() -> tuple:
    """-> (mesh, axis) of the innermost context."""
    if not _TP_CONTEXT:
        raise RuntimeError(
            "attn_impl='flash_tp' requires an active use_tensor_parallel "
            "(mesh, axis) context when the attention runs")
    return _TP_CONTEXT[-1]


def tp_group():
    """(process group, size, this rank's index) of the context's axis."""
    mesh, axis = current_tp()
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _head_rows(n_rows: int, n_tp: int, r: int, fused: int) -> torch.Tensor:
    """Indices of rank r's rows of a weight whose output dim is ``fused``
    equal parts (3 for Wqkv: q, k, v), each split over n_tp ranks."""
    part = n_rows // fused
    loc = part // n_tp
    return torch.cat([torch.arange(i * part + r * loc, i * part + (r + 1) * loc)
                      for i in range(fused)])


def _tp_split(name: str, shape, n_tp: int, r: int):
    """-> (dim, indices) of rank r's shard of a full tensor, or None for a
    replicated one."""
    parts = name.split(".")
    leaf = parts[-1]
    if any(p in COLUMN for p in parts) and leaf in ("weight", "bias"):
        fused = 3 if "Wqkv" in parts else 1
        return 0, _head_rows(shape[0], n_tp, r, fused)
    if any(p in ROW for p in parts) and leaf == "weight":
        loc = shape[1] // n_tp
        return 1, torch.arange(r * loc, (r + 1) * loc)
    return None


def _tp_modules(model):
    from ..nn.layers import MHA, Mlp

    for name, mod in model.named_modules():
        if ((isinstance(mod, MHA) and mod.attn_impl == "flash_tp")
                or (isinstance(mod, Mlp) and mod.tp)):
            yield name, mod


@torch.no_grad()
def shard_tp_params(model, mesh, axis: str = "tp"):
    """Keep, in place, this rank's shard of every projection of the
    model's ``flash_tp`` blocks (the module docstring's layout).  Build
    the optimizer after this call: the parameters are new tensors."""
    group = mesh.get_group(axis)
    n_tp, r = dist.get_world_size(group), dist.get_rank(group)
    for _, mod in _tp_modules(model):
        for pname, p in list(mod.named_parameters()):
            split = _tp_split(pname, p.shape, n_tp, r)
            if split is None:
                continue
            if p.shape[split[0]] % n_tp:
                raise ValueError(f"{pname} {tuple(p.shape)} does not split "
                                 f"over {n_tp} ranks")
            owner, leaf = mod.get_submodule(pname.rsplit(".", 1)[0]), \
                pname.rsplit(".", 1)[1]
            local = p.index_select(split[0], split[1].to(p.device))
            setattr(owner, leaf, torch.nn.Parameter(
                local.contiguous(), requires_grad=p.requires_grad))
    return model


def gather_tp_tensor(name: str, local: torch.Tensor, mesh,
                     axis: str = "tp") -> torch.Tensor:
    """The full tensor of a ``shard_tp_params`` shard (a weight, or its
    gradient) named as in the model's state dict."""
    group = mesh.get_group(axis)
    n_tp = dist.get_world_size(group)
    full_shape = list(local.shape)
    split = _tp_split(name, local.shape, 1, 0)
    if split is None or n_tp == 1:
        return local
    dim = split[0]
    full_shape[dim] *= n_tp
    parts = [torch.empty_like(local) for _ in range(n_tp)]
    dist.all_gather(parts, local.contiguous(), group=group)
    full = local.new_empty(full_shape)
    for r, part in enumerate(parts):
        idx = _tp_split(name, full_shape, n_tp, r)[1].to(local.device)
        full.index_copy_(dim, idx, part)
    return full


def gather_tp_state_dict(model, mesh, axis: str = "tp",
                         grads: bool = False) -> dict:
    """The full state dict (or, with ``grads``, the full gradient of each
    parameter) of a model whose ``flash_tp`` projections are sharded."""
    tp_names = {f"{m}.{p}" if m else p for m, mod in _tp_modules(model)
                for p, _ in mod.named_parameters()}
    if grads:
        items = [(n, p.grad) for n, p in model.named_parameters()]
    else:
        items = list(model.state_dict().items())
    return {n: (gather_tp_tensor(n, t, mesh, axis) if n in tp_names
                and t is not None else t) for n, t in items}
