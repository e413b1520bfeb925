"""Device mesh (counterpart of octcubem_tpu/core/mesh.py).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with a
``data`` axis for the batch, an ``fsdp`` axis for parameters and an
optional innermost ``sp`` axis for the sequence; XLA emits the
collectives.  Here the mesh is a ``torch.distributed`` ``DeviceMesh``
over the ranks of the default process group, one rank per card, with
the same axis names, and the collectives are explicit
(``parallel/sequence.py``).  The process group is the caller's:
``init_process_group`` with its address or store, world size and rank.
``batch_sharding``, ``replicated`` and ``fsdp_param_spec`` wait for the
data-parallel training slice (ROADMAP A14).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

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
    world = dist.get_world_size()
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
