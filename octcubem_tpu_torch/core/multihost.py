"""Process groups, placement and the data-parallel collectives of the
port's CLIs (counterpart of octcubem_tpu/core/multihost.py).

A rank is one process driving one card: the JAX package's host with one
device.  ``initialize`` forms the default ``torch.distributed`` group
from the launcher's environment (``torchrun``: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) or from an explicit
store, and ``maybe_initialize`` joins when ``WORLD_SIZE`` > 1, as JAX
joins on ``JAX_NUM_PROCESSES`` > 1.  Without a group the port runs on
one rank and every collective below is the identity.

Placement.  JAX's ``global_batch`` and ``put_tree`` build global arrays
from each host's part; here they return ``DTensor``s built from this
rank's part (``DTensor.from_local``, no communication), whose placements
are JAX's (``core/mesh.placements``), and the engines compute on their
local tensors (``local``).  ``local_rows`` reads this rank's rows back.

Collectives.  The engines reduce explicitly, not through
``DistributedDataParallel``'s hooks, which ``torch.autograd.grad`` (the
MAE and fine-tune steps' out-of-place gradients) never fires:
``all_reduce_mean`` sums a list of tensors in flat buckets and divides by
the group's size (gloo has no AVG); ``all_gather`` concatenates the
ranks' tensors along a dim in rank order and ``reduce_scatter`` keeps
this rank's block of their sum (along a dim other than 0 both return a
strided view, which the consumer copies where it needs rows); ``all_gather_with_grad`` is the gather
whose backward is that reduce-scatter (every rank's loss reads every
block), which the CLIP loss's features, the sequence-parallel stacks and
the fsdp-sharded params (``core/fsdp.py``) go through.  The gloo backend
takes CUDA tensors only in all_reduce, broadcast and barrier, so on gloo
a gather of CUDA tensors is an all_reduce of a zero-padded buffer and a
reduce-scatter an all_reduce of the whole tensor, of which the rank
keeps its block; NCCL and gloo on the CPU run the real collectives.
bf16 travels through gloo as fp32.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist


def world() -> tuple[int, int]:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize(init_method: str | None = None, *, store=None,
               world_size: int | None = None, rank: int | None = None,
               local_rank: int | None = None, backend: str | None = None,
               device: str | torch.device | None = None,
               timeout_s: float | None = None) -> dict:
    """Form the default process group and return ``summary()``.

    With no arguments the launcher's environment decides (``env://``:
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); ``store``
    (e.g. a ``FileStore``) with ``world_size`` and ``rank`` replaces the
    rendezvous.  ``device``: the ranks' device, the card unless the caller
    asks for the CPU; on the card the rank takes ``cuda:LOCAL_RANK`` and
    the backend is NCCL, on the CPU gloo.  An explicit ``backend`` is for
    ranks that share one card (NCCL refuses two ranks on one device), as
    ``chip_smoke.py`` runs them through gloo."""
    from .device import resolve_device

    dev = resolve_device(device)
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method or "env://"
    dist.init_process_group(backend, world_size=world_size, rank=rank, **kw)
    return summary()


def shutdown() -> None:
    """Leave the default process group, if one is formed, after dropping
    the process's captured step graphs (``train/step_graph.release_all``):
    NCCL's destroy waits until every graph that captured one of the
    group's collectives is gone."""
    if dist.is_available() and dist.is_initialized():
        from ..train.step_graph import release_all

        release_all()
        dist.destroy_process_group()


def summary() -> dict:
    rank, size = world()
    n_local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {"process_index": rank, "process_count": size,
            "local_devices": n_local, "global_devices": n_local * size}


def maybe_initialize(device: str | torch.device | None = None) -> dict:
    """CLI-startup hook: join the launcher's group when it asks for
    several processes (``WORLD_SIZE`` > 1) and none is formed yet; a
    formed group (a caller's own) is kept; one process is a no-op."""
    if (int(os.environ.get("WORLD_SIZE", "1")) > 1
            and not (dist.is_available() and dist.is_initialized())):
        return initialize(device=device)
    return summary()


def announce(device: str | torch.device | None = None) -> dict:
    """The shared CLI-startup block: ``maybe_initialize``, the kernel
    build for a run on the card (``core/runtime.py``), and one status
    line when several processes formed a group."""
    from .runtime import setup_compilation_cache

    info = maybe_initialize(device)
    setup_compilation_cache(device=device)
    if info["process_count"] > 1:
        print(f"[multihost] process {info['process_index']}/"
              f"{info['process_count']}, backend "
              f"{dist.get_backend()}")
    return info


# ------------------------------------------------------------- placement

def local(t):
    """This rank's tensor of a ``DTensor``; any other value as it is."""
    to_local = getattr(t, "to_local", None)
    return to_local() if callable(to_local) else t


def local_rows(t) -> np.ndarray:
    """This process's rows of a batch, as numpy (a host read: it waits
    for the card), in the order this rank fed them to ``global_batch``."""
    t = local(t)
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _chunk(t: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """This rank's chunk of a full tensor under ``spec`` (torch.chunk's
    split, as ``Shard`` splits)."""
    for dim, name in enumerate(spec):
        if name is not None:
            n = mesh.size(mesh.mesh_dim_names.index(name))
            t = t.chunk(n, dim)[mesh.get_local_rank(name)]
    return t


def map_tree(fn, tree, path=""):
    """``fn(dotted name, leaf)`` over a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{path}.{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, f"{path}.{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def put_tree(mesh, tree, spec_fn=None):
    """Place a tree (dicts, lists, tuples) of tensors that every rank holds
    in full as ``DTensor``s over ``mesh``.  ``spec_fn(name, tensor) ->
    spec`` (a JAX-style spec tuple; ``core/mesh.fsdp_param_spec`` for the
    size policy) picks each leaf's placement, replicated by default; a
    sharded leaf keeps only this rank's chunk.  Non-tensor leaves pass
    through."""
    from torch.distributed.tensor import DTensor

    from .mesh import placements

    def place(name, x):
        if not isinstance(x, torch.Tensor):
            return x
        spec = tuple(spec_fn(name, x)) if spec_fn is not None else ()
        return DTensor.from_local(_chunk(x, mesh, spec), mesh,
                                  placements(mesh, spec), run_check=False,
                                  shape=x.shape, stride=x.stride())

    return map_tree(place, tree)


def global_batch(mesh, local_tensor, axis: str = "data",
                 micro_axis: bool = False):
    """The global batch-sharded ``DTensor`` of which ``local_tensor`` is
    this rank's part: ranks of ``axis`` hold consecutive row blocks in
    rank order (JAX's ``make_array_from_process_local_data`` layout);
    ``micro_axis``: dim 0 is an accumulation axis and dim 1 is sharded.
    Ranks along the mesh's other axes hold the same rows."""
    from torch.distributed.tensor import DTensor

    from .mesh import axis_coord, placements

    t = torch.as_tensor(local_tensor)
    dim = 1 if micro_axis else 0
    n = axis_coord(mesh, axis)[1]
    shape = list(t.shape)
    shape[dim] *= n
    spec = (None, axis) if micro_axis else (axis,)
    return DTensor.from_local(t, mesh, placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


# ----------------------------------------------------------- collectives

def _size(group=None) -> int:
    return dist.get_world_size(group) if world()[1] > 1 else 1


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the backend carries it: gloo has no bf16 / fp16 reduce."""
    if (dist.get_backend(group) == "gloo"
            and t.dtype in (torch.bfloat16, torch.float16)):
        return t.float()
    return t


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over the group's ranks, out of place."""
    if _size(group) == 1:
        return t
    buf = _wire(t, group).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.dtype)


def all_reduce_mean(tensors, group=None, bucket_elems: int = 1 << 25):
    """The mean over the group's ranks of each tensor (None stays None),
    out of place: one all_reduce (SUM) per flat bucket of at most
    ``bucket_elems`` elements of one dtype and device, then / size."""
    n = _size(group)
    tensors = list(tensors)
    if n == 1:
        return tensors
    out = list(tensors)
    buckets: dict = {}
    for i, t in enumerate(tensors):
        if t is not None:
            buckets.setdefault((t.dtype, t.device), []).append(i)
    for idx in buckets.values():
        start = 0
        while start < len(idx):
            stop, elems = start, 0
            while stop < len(idx) and (stop == start or elems
                                       + tensors[idx[stop]].numel()
                                       <= bucket_elems):
                elems += tensors[idx[stop]].numel()
                stop += 1
            part = idx[start:stop]
            flat = torch.cat([tensors[i].reshape(-1) for i in part])
            flat = all_reduce_sum(flat, group).div_(n)
            for i, seg in zip(part, flat.split(
                    [tensors[i].numel() for i in part])):
                out[i] = seg.view(tensors[i].shape)
            start = stop
    return out


def _gather_flat(t: torch.Tensor, group, n: int, r: int) -> torch.Tensor:
    """[n, *t.shape]: every rank's ``t`` in rank order."""
    t = _wire(t.contiguous(), group)
    if dist.get_backend(group) == "gloo" and t.is_cuda:
        buf = t.new_zeros((n,) + t.shape)
        buf[r] = t
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf
    buf = t.new_empty((n * t.shape[0],) + t.shape[1:])
    dist.all_gather_into_tensor(buf, t, group=group)
    return buf.view((n,) + t.shape)


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order (no
    gradient)."""
    n = _size(group)
    if n == 1:
        return t
    moved = t.detach().movedim(dim, 0)
    out = _gather_flat(moved, group, n, dist.get_rank(group))
    out = out.reshape((n * moved.shape[0],) + moved.shape[1:]).to(t.dtype)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` (``t.chunk(n, dim)[rank]``) of the
    sum over the group's ranks of ``t``."""
    n = _size(group)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {n} ranks")
    r = dist.get_rank(group)
    full = _wire(t.movedim(dim, 0).contiguous(), group)
    if dist.get_backend(group) == "gloo" and full.is_cuda:
        full = full.clone() if full.data_ptr() == t.data_ptr() else full
        dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
        out = full.chunk(n)[r]
    else:
        out = full.new_empty((full.shape[0] // n,) + full.shape[1:])
        dist.reduce_scatter_tensor(out, full, op=dist.ReduceOp.SUM,
                                   group=group)
    return out.to(t.dtype).movedim(0, dim)


class _AllGather(torch.autograd.Function):
    """``all_gather`` with a gradient: the backward is its transpose, the
    reduce-scatter (sum) of the gathered tensor's gradient."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


def all_gather_with_grad(t: torch.Tensor, group=None,
                         dim: int = 0) -> torch.Tensor:
    if _size(group) == 1:
        return t
    return _AllGather.apply(t, group, dim)


def broadcast_(tensors, src: int = 0, group=None) -> None:
    """Every rank's tensors set to rank ``src``'s, in place."""
    if _size(group) == 1:
        return
    for t in tensors:
        buf = _wire(t.data, group)
        buf = buf.contiguous() if buf is t.data else buf
        dist.broadcast(buf, src=src, group=group)
        if buf is not t.data:
            t.data.copy_(buf)


def barrier() -> None:
    if world()[1] > 1:
        dist.barrier()
