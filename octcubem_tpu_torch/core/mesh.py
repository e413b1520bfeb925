"""Device mesh (counterpart of octcubem_tpu/core/mesh.py).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with a
``data`` axis for the batch, an ``fsdp`` axis for parameters and an
optional innermost ``sp`` axis for the sequence; XLA emits the
collectives.  Here the mesh is a ``torch.distributed`` ``DeviceMesh``
over the ranks of the default process group, one rank per card, with
the same axis names, and the collectives are explicit
(``parallel/``, ``core/multihost.py``).  The process group is formed
by ``core/multihost.initialize`` (or the caller's ``init_process_group``).

A rank is one card: JAX's host with one device.  A placement is written
as JAX writes it, a spec tuple of one mesh axis name (or None) per
tensor dim (``()`` replicates); ``placements`` turns it into the
``DTensor`` placements of a ``DeviceMesh``.  ``batch_sharding`` and
``replicated`` are those placements for a batch and for a replicated
tensor, and ``fsdp_param_spec`` is JAX's size policy on the port's
reference-layout weights.  As in the JAX CLIs, no CLI applies it: they
replicate their params.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from .device import resolve_device

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
SP_AXIS = "sp"


def make_mesh(n_data: int | None = None, n_fsdp: int = 1,
              device: str | torch.device | None = None,
              n_sp: int = 1) -> DeviceMesh:
    """Build a (data, fsdp[, sp]) mesh over ranks 0 .. need - 1 of the
    default process group.  Defaults to all ranks on the data axis.
    n_sp > 1 appends a sequence-parallel axis (innermost, so an sp group is
    neighbouring ranks).  ``device``: the ranks' device type, the card
    unless the caller asks for the CPU (``core/device.resolve_device``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // (n_fsdp * n_sp)
    if n_data < 1:
        raise ValueError(
            f"mesh needs at least n_fsdp*n_sp = {n_fsdp * n_sp} devices, "
            f"have {world} (n_data would be 0)")
    need = n_data * n_fsdp * n_sp
    if need > world:
        raise ValueError(f"need {need} devices, have {world}")
    if n_sp > 1:
        shape, names = (n_data, n_fsdp, n_sp), (DATA_AXIS, FSDP_AXIS, SP_AXIS)
    else:
        shape, names = (n_data, n_fsdp), (DATA_AXIS, FSDP_AXIS)
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(need).reshape(shape),
                      mesh_dim_names=names)


def cli_mesh(n_data: int | None = None, n_fsdp: int = 1,
             device: str | torch.device | None = None,
             n_sp: int = 1) -> DeviceMesh | None:
    """A CLI's mesh: None on one process with no group and no axis above
    1 (every step then runs on this rank alone), else ``make_mesh``,
    which refuses a mesh larger than the group as JAX's refuses one
    larger than the host's devices.  It must span the group: a rank
    outside it would take no part in the reductions."""
    if not dist.is_initialized() and (n_data or 1) * n_fsdp * n_sp == 1:
        return None
    mesh = make_mesh(n_data, n_fsdp, device, n_sp)
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh {tuple(mesh.shape)} spans "
                         f"{mesh.size()} of {dist.get_world_size()} ranks")
    return mesh


def axis_coord(mesh: DeviceMesh | None, axis: str) -> tuple[int, int]:
    """(this rank's index along ``axis``, the axis size); (0, 1) with no
    mesh or no such axis."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0, 1
    return mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))


def check_mesh(mesh: DeviceMesh | None) -> bool:
    """Whether a step over ``mesh`` reduces across ranks; a mesh must span
    the process group (its mean is over every rank)."""
    if mesh is None:
        return False
    size = dist.get_world_size() if dist.is_initialized() else 1
    if mesh.size() != size:
        raise ValueError(f"the mesh spans {mesh.size()} of {size} ranks")
    return size > 1


def data_group(mesh: DeviceMesh):
    """The process group of this rank's data axis: the ranks whose rows
    make up the global batch."""
    return mesh.get_group(DATA_AXIS)


def placements(mesh: DeviceMesh, spec: tuple = ()) -> list:
    """A spec tuple (one mesh axis name or None per tensor dim, as a JAX
    ``PartitionSpec``) -> the ``DTensor`` placements over ``mesh``:
    ``Shard(dim)`` on the axis a dim names, ``Replicate()`` elsewhere."""
    out = [Replicate()] * mesh.ndim
    for dim, name in enumerate(spec):
        if name is not None:
            out[mesh.mesh_dim_names.index(name)] = Shard(dim)
    return out


def batch_sharding(mesh: DeviceMesh) -> list:
    """Shard the leading (batch) dim over the data axis."""
    return placements(mesh, (DATA_AXIS,))


def replicated(mesh: DeviceMesh) -> list:
    return placements(mesh, ())


def _flax_shape(name: str, shape: tuple) -> tuple:
    """The JAX package's shape of a port tensor: a Dense weight is stored
    [out, in] here and [in, out] there; every other leaf of the ViT and
    MAE trees has one shape in both."""
    if len(shape) == 2 and name.endswith("weight"):
        return shape[::-1]
    return shape


def fsdp_param_spec(name: str, tensor) -> tuple:
    """Shard the largest dim of big weights over fsdp; replicate the rest.

    JAX's size-threshold policy (octcubem_tpu/core/mesh.py:fsdp_param_spec):
    a weight of >= 2**20 elements gets its longest axis sharded, the first
    such axis of its JAX shape, so a square Dense weight is sharded on its
    input dim as there."""
    shape = tuple(getattr(tensor, "shape", ()))
    if len(shape) >= 2 and int(np.prod(shape)) >= 2**20:
        axis = int(np.argmax(_flax_shape(name, shape)))
        if len(shape) == 2 and name.endswith("weight"):
            axis = 1 - axis
        spec = [None] * len(shape)
        spec[axis] = FSDP_AXIS
        return tuple(spec)
    return ()
