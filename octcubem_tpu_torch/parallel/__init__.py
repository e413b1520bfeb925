"""Parallel paths over ``torch.distributed`` (counterpart of
octcubem_tpu/parallel/): the mesh and its placements (``core/mesh.py``),
batch and state placement for data parallelism (``shard_batch``,
``replicate_state``; the engines reduce their gradients explicitly, see
``core/multihost.py``), sequence-parallel attention (``sequence``,
attn_impl="flash_sp") and head-parallel attention (``tensor``,
attn_impl="flash_tp").  The CLIP loss gathers features across ranks in
``train/clip_engine.py``."""

from ..core.mesh import (DATA_AXIS, FSDP_AXIS, SP_AXIS,  # noqa: F401
                         batch_sharding, fsdp_param_spec, make_mesh,
                         replicated)
from ..train.mae_engine import replicate_state, shard_batch  # noqa: F401
from .sequence import (current_sp, ring_attention,  # noqa: F401
                       sequence_parallel_attention, shard_sequence,
                       use_sequence_parallel)
from .tensor import (current_tp, head_parallel_attention,  # noqa: F401
                     shard_tp_params, tp_param_spec, use_tensor_parallel)
