"""Parameter and optimizer-state sharding over the mesh's ``fsdp`` axis
(counterpart of ``put_tree(mesh, state, fsdp_param_spec)``,
octcubem_tpu/core/multihost.py, under which GSPMD runs the JAX steps).

``shard_state(state, mesh, spec_fn)`` places a ``TrainState`` that every
rank holds in full, as ``put_tree`` takes a tree every host holds: each
param that ``spec_fn`` (``core/mesh.fsdp_param_spec`` by default, JAX's
size policy) shards over ``fsdp`` keeps, in place, this rank's chunk of
itself and of its AdamW moments ``mu`` and ``nu`` (the chunk of JAX's
``NamedSharding``, ``torch.chunk``'s split), and every other leaf stays
whole.  The state's AdamW then carries its layout, an ``FsdpShards``, as
``state.tx.shards``, which ``state.shards`` reads.

A step on such a state (the MAE, CLIP and fine-tune steps) runs its
forwards and backwards inside ``gathered(state, mesh)``: once per step,
each sharded param reads as its whole tensor, all-gathered over fsdp by
``multihost.all_gather_with_grad``, whose backward reduce-scatters the
gradient, so a chunk param's gradient is the sum over the fsdp ranks of
their gradients' chunks.  The swap lasts until the step's backwards are
done, so a rematerialised block's recompute and a second module over the
same param objects (``MaskedAutoencoderViT3D.with_remat``) read the same
gathered tensors.  ``reduce`` then takes the mean over every rank of the
mesh (a chunk over the data axis, divided by the fsdp degree; a whole
leaf over all ranks, as a replicated state's), and ``optim.grad_norm``
and AdamW's clip take the norm of the global gradient.

Ranks of one data index hold the same rows (the batch is sharded over
``data`` alone, JAX's ``P("data")``), so they compute the same loss and
their gradients agree.  The whole weights live only while a step runs:
between steps a rank holds a sharded leaf's param and moments, 12 bytes
a param in fp32, over the fsdp degree.

Checkpoints (``core/checkpoint.py``) hold whole tensors: every rank takes
part in each sharded leaf's gather and rank 0 keeps host copies
(``host_state_dict``); a restore cuts them to the layout of the state it
restores into (``local_state_dict``), so a run resumes on another fsdp
degree, or on one rank.
"""

from __future__ import annotations

import contextlib

import torch

from . import multihost
from .mesh import (FSDP_AXIS, SP_AXIS, axis_coord, data_group,
                   fsdp_param_spec, fsdp_group)


class FsdpShards:
    """The fsdp layout of a module's params: for each param that
    ``spec_fn(name, param)`` shards, the dim split over the mesh's fsdp
    axis.  Built from the whole params, before they are cut."""

    def __init__(self, mesh, model: torch.nn.Module, spec_fn=fsdp_param_spec):
        if axis_coord(mesh, SP_AXIS)[1] > 1:
            raise ValueError("fsdp sharding on a mesh with an sp axis is "
                             "not supported")
        self.mesh = mesh
        self.rank, self.n = axis_coord(mesh, FSDP_AXIS)
        self.group = fsdp_group(mesh)
        self.dims: dict[str, int] = {}   # every name of a sharded param
        by_id: dict[int, tuple] = {}     # id(param) -> (param, dim, owners)
        for name, p in model.named_parameters(remove_duplicate=False):
            dim = by_id[id(p)][1] if id(p) in by_id else self._dim(
                name, p, tuple(spec_fn(name, p)))
            if dim is None:
                continue
            self.dims[name] = dim
            owner, _, attr = name.rpartition(".")
            entry = by_id.setdefault(id(p), (p, dim, []))
            entry[2].append((model.get_submodule(owner), attr))
        self._params = list(by_id.values())
        self._ids = {i: dim for i, (_, dim, _) in by_id.items()}

    def _dim(self, name: str, p, spec: tuple) -> int | None:
        axes = [d for d, a in enumerate(spec) if a is not None]
        if not axes:
            return None
        if len(axes) > 1 or spec[axes[0]] != FSDP_AXIS:
            raise ValueError(f"{name}: spec {spec} shards over another axis "
                             f"than {FSDP_AXIS!r}")
        if p.shape[axes[0]] % self.n:
            raise ValueError(f"{name} {tuple(p.shape)}: dim {axes[0]} does "
                             f"not split over {self.n} fsdp ranks")
        return axes[0]

    # ---------------------------------------------------------- chunks

    def local(self, t: torch.Tensor, dim: int | None) -> torch.Tensor:
        """This rank's chunk of a whole tensor along ``dim`` (None: whole)."""
        return t if dim is None else t.chunk(self.n, dim)[self.rank]

    def whole(self, t: torch.Tensor, dim: int | None) -> torch.Tensor:
        """The whole tensor of this rank's chunk; a collective over fsdp."""
        return t if dim is None else multihost.all_gather(t, self.group, dim)

    def mask(self, params) -> list[bool]:
        """Per param (by identity), whether this rank holds a chunk of it."""
        return [id(p) in self._ids for p in params]

    def _tx_dims(self, tx) -> dict[str, int]:
        return {n: self._ids[id(p)] for n, p in zip(tx.names, tx.params)
                if id(p) in self._ids}

    @torch.no_grad()
    def shard_(self, state) -> None:
        """Cut the state's sharded params and their moments to this rank's
        chunks in place (the param objects stay, their data shrinks)."""
        for p, dim, _ in self._params:
            p.data = self.local(p.data, dim).clone()
            p.grad = None
        tx = state.tx
        for i, p in enumerate(tx.params):
            dim = self._ids.get(id(p))
            if dim is not None:
                tx.mu[i] = self.local(tx.mu[i], dim).clone()
                tx.nu[i] = self.local(tx.nu[i], dim).clone()
        tx.shards = self

    # ----------------------------------------------------------- a step

    @contextlib.contextmanager
    def gathered(self):
        """Inside, each sharded param reads as its whole tensor (gathered
        with a gradient that reduce-scatters to the chunk param)."""
        for p, dim, owners in self._params:
            # a gather along dim 1 is a strided view; the copy gives the
            # weight its param's layout, so the GEMMs are a replicated
            # state's
            full = multihost.all_gather_with_grad(p, self.group,
                                                  dim).contiguous()
            for mod, attr in owners:
                mod._parameters[attr] = full
        try:
            yield
        finally:
            for p, _, owners in self._params:
                for mod, attr in owners:
                    mod._parameters[attr] = p

    def reduce(self, params, grads) -> list:
        """The mean over every rank of the mesh of each gradient (None
        stays None): a chunk's gradient, already summed over fsdp by the
        gather's backward, over the data axis and / the fsdp degree; a
        whole leaf's over all ranks."""
        sharded = self.mask(params)
        out = list(grads)
        for flag, group in ((False, None), (True, data_group(self.mesh))):
            idx = [i for i, s in enumerate(sharded) if s == flag]
            means = multihost.all_reduce_mean([grads[i] for i in idx], group)
            for i, g in zip(idx, means):
                out[i] = g / self.n if flag and g is not None and self.n > 1 \
                    else g
        return out

    # ----------------------------------------------------- checkpoints

    def host_state_dict(self, state, keep: bool) -> dict | None:
        """``state.state_dict()`` with whole tensors, as host copies where
        ``keep`` (else None).  Every rank calls it: each sharded leaf's
        gather is a collective, one leaf at a time."""
        sd = state.state_dict()

        def host(t, dim=None):
            if isinstance(t, torch.Tensor):
                t = self.whole(t, dim)
                return t.detach().to("cpu", copy=True,
                                     memory_format=torch.contiguous_format) \
                    if keep else None
            return t

        tx_dims = self._tx_dims(state.tx)
        out = {k: host(v) for k, v in sd.items()
               if k not in ("params", "opt_state")}
        out["params"] = {k: host(v, self.dims.get(k))
                         for k, v in sd["params"].items()}
        opt = sd["opt_state"]
        out["opt_state"] = {"count": host(opt["count"])}
        for key in ("mu", "nu"):
            out["opt_state"][key] = {k: host(v, tx_dims.get(k))
                                     for k, v in opt[key].items()}
        return out if keep else None

    def local_state_dict(self, sd: dict, tx) -> dict:
        """A whole-tensor state dict cut to this rank's chunks."""
        tx_dims = self._tx_dims(tx)
        out = dict(sd)
        out["params"] = {k: self.local(v, self.dims.get(k))
                         for k, v in sd["params"].items()}
        opt = dict(sd["opt_state"])
        for key in ("mu", "nu"):
            opt[key] = {k: self.local(v, tx_dims.get(k))
                        for k, v in opt[key].items()}
        out["opt_state"] = opt
        return out


def shard_state(state, mesh, spec_fn=fsdp_param_spec):
    """``put_tree(mesh, state, spec_fn)`` for the port's ``TrainState``
    (module docstring), in place -> the state.  Every rank must hold the
    same whole state, as every host must for JAX's (params from one
    seed); build the steps with the same ``mesh``."""
    if state.shards is not None:
        raise ValueError("the state is already sharded")
    FsdpShards(mesh, state.params, spec_fn).shard_(state)
    return state


def gathered(state, mesh):
    """The step's context: ``state.shards.gathered()`` for a sharded
    state, which must be sharded over the step's ``mesh``; nothing for
    a replicated one."""
    shards = state.shards
    if shards is None:
        return contextlib.nullcontext()
    if shards.mesh is not mesh:
        raise ValueError("the state is sharded over another mesh than the "
                         "step's")
    return shards.gathered()


def mean_grads(state, params, grads, reduce: bool) -> list:
    """The step's gradient reduction: ``state.shards.reduce`` for a
    sharded state, else (``reduce``: a mesh of several ranks) the mean
    over every rank, else the gradients as they are."""
    if state.shards is not None:
        return state.shards.reduce(params, grads)
    return multihost.all_reduce_mean(grads) if reduce else list(grads)
