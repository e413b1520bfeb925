"""Parallel paths over ``torch.distributed`` (counterpart of
octcubem_tpu/parallel/): the mesh (``core/mesh.py``, re-exported) and
sequence-parallel attention (``sequence``).  Head-parallel attention
(attn_impl="flash_tp"), batch placement and parameter sharding are not
ported yet (ROADMAP A14)."""

from ..core.mesh import DATA_AXIS, FSDP_AXIS, SP_AXIS, make_mesh  # noqa: F401
from .sequence import (current_sp, ring_attention,  # noqa: F401
                       sequence_parallel_attention, shard_sequence,
                       use_sequence_parallel)
