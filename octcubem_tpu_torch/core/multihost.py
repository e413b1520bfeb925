"""Process-group summary and host reads for the port's CLIs (counterpart
of the one-rank part of octcubem_tpu/core/multihost.py).

The port runs on one rank until ROADMAP A14 (DDP / FSDP training): the
world is the ``torch.distributed`` group when one is initialized, else
this one process.  Joining a cluster and placing global batches
(``initialize``, ``put_tree``, ``global_batch``) raise, naming A14.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

_A14 = ("multi-process training is ROADMAP A14 (DDP / FSDP over "
        "torch.distributed); the port runs on one rank")


def world() -> tuple[int, int]:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def summary() -> dict:
    rank, size = world()
    n_local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {"process_index": rank, "process_count": size,
            "local_devices": n_local, "global_devices": n_local * size}


def maybe_initialize() -> dict:
    """CLI-startup hook: a launcher that asks for several processes
    (``WORLD_SIZE`` > 1) is refused until A14; one process is a no-op."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(_A14)
    return summary()


def announce(device: str | torch.device | None = None) -> dict:
    """The shared CLI-startup block: ``maybe_initialize``, the kernel
    build for a run on the card (``core/runtime.py``), and one status
    line when several processes formed a group."""
    from .runtime import setup_compilation_cache

    info = maybe_initialize()
    setup_compilation_cache(device=device)
    if info["process_count"] > 1:
        print(f"[multihost] process {info['process_index']}/"
              f"{info['process_count']}, {info['global_devices']} "
              "global devices")
    return info


def local_rows(t) -> np.ndarray:
    """This process's rows of a batch, as numpy (a host read: it waits
    for the card).  One rank holds every row."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def initialize(*args, **kwargs) -> dict:
    raise NotImplementedError(_A14)


def put_tree(*args, **kwargs):
    raise NotImplementedError(_A14)


def global_batch(*args, **kwargs):
    raise NotImplementedError(_A14)
