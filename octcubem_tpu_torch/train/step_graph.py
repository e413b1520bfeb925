"""A train step replayed as one captured CUDA graph.

A step on the card issues a few thousand kernels, one Python call each;
at the MAE cell's shapes the host takes longer to issue them than the
card to run them.  Captured once into a ``torch.cuda.CUDAGraph``, the
same kernels replay from one launch.  The graph captures the step's own
body, so there is no second implementation: what a replay runs is what
the eager step ran when it was captured.

Where it engages (``engages``), from what the step can observe: the
batch on a CUDA device, a state that is not sharded over fsdp, no
``torch.profiler`` session recording (``utils/profiling.recording``; a
replay cannot re-emit the step's host ranges, which the profiled
metrics read, and the device runs the same kernels in the same order
either way), and no mesh, a mesh of one rank, or a mesh of several
ranks with no ``sp`` axis whose process groups (the default one, over
which the step reduces, and each axis's) are all NCCL.  On such a mesh
the gradient's and the losses' all-reduces are kernels on the card and
are captured with the rest; every rank captures and replays at the
same call, since every rank runs the same steps with the same keys.  A
rank that a profiler records runs its step eagerly while the others
replay: the collectives meet all the same (the same buckets in the
same order), as NCCL lets one communicator run inside graphs and
outside them.  Anywhere else the step runs eagerly, as before: gloo
collectives run on the host, and a sharded state's gathers and an
``sp`` mesh's ring have no capture to hold them.

``StepGraphs`` keeps one graph per key (the inputs' shapes and dtypes,
and what else the caller's key holds), at most ``MAX_GRAPHS``; past
that a new key runs eagerly.  A key's first call is a real step run
eagerly on a side stream (the warm-up: lazy initialisation, the
optimizer's LR table, caches such as the model's frame index, all
before any capture); its second is captured and then
replayed once; every later call copies its inputs into the graph's
static buffers, replays, and returns clones of the graph's outputs, so
the caller owns what it gets.  The step's generator is registered with
the graph, so draws inside it (drop path, noise the caller did not pass)
differ on every replay.  The optimizer's count is a tensor on the card,
which the graph advances in place (``train/optim.py``).  Before
the capture the warm-up's cached blocks are returned to the device
(``torch.cuda.empty_cache``), so its activations are not held twice,
once there and once in the graph's private pool.  A step whose model
checkpoints a block with drop path is not captured at all
(``capturable``): the recompute makes a generator, which no capture
allows.  A capture that fails for any other reason raises.

The step's record (``utils/profiling.step``) says which it was under
``path``: ``warmup``, ``capture``, ``replay`` (its host time, the copy
in, the launch and the clones, in the phase ``replay``) or ``eager``;
the capture's record holds ``pool_bytes``, the bytes the graph's private
memory pool reserves, and ``reserved_bytes``, all the device memory the
allocator then reserves, the pool included.  ``ops/_cuda.launches``
counts a replay's kernel calls as its capture counted them.

NCCL's destroy of a communicator waits until every graph that captured
one of its collectives is gone, so ``core/multihost.shutdown`` drops
every captured graph of the process first (``release_all``).
"""

from __future__ import annotations

import weakref

import torch
import torch.distributed as dist

from ..core.mesh import SP_AXIS
from ..nn.layers import TransformerStack
from ..ops import _cuda
from ..utils import profiling

MAX_GRAPHS = 4
_LIVE: weakref.WeakSet = weakref.WeakSet()  # every StepGraphs alive


def release_all() -> None:
    """Drop every captured graph of the process; a step that is called
    again warms up and captures anew."""
    for graphs in list(_LIVE):
        graphs.graphs.clear()
        graphs.last = None


def capturable(*models) -> bool:
    """False where one of ``models`` checkpoints a block with drop path
    (``nn/layers._checkpointed``): its recompute needs a new generator,
    which no capture allows."""
    return not any(
        stack.remat and any(b.drop_path1.rate or b.drop_path2.rate
                            for b in stack)
        for m in models for stack in m.modules()
        if isinstance(stack, TransformerStack))


def engages(device: torch.device, mesh=None, shards=None) -> bool:
    """Whether a step on ``device`` over ``mesh`` with a state sharded by
    ``shards`` replays a captured graph (module docstring)."""
    return (device.type == "cuda" and shards is None
            and not profiling.recording()
            and (mesh is None or mesh.size() == 1 or _nccl_mesh(mesh)))


def _nccl_mesh(mesh) -> bool:
    """A mesh with no ``sp`` axis whose groups (the default group, over
    which the step reduces, and each axis's) are all NCCL."""
    names = mesh.mesh_dim_names or ()
    return SP_AXIS not in names and all(
        dist.get_backend(g) == "nccl"
        for g in [None, *(mesh.get_group(n) for n in names)])


def signature(tree):
    """The shapes, dtypes and devices of a nest of tensors (dicts, lists,
    tuples, None), as a hashable key."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return tuple((k, signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(signature(v) for v in tree)
    return tree


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _copy_into(static, tree) -> None:
    if isinstance(static, torch.Tensor):
        if static.data_ptr() != tree.data_ptr():
            static.copy_(tree)
    elif isinstance(static, dict):
        for k, v in static.items():
            _copy_into(v, tree[k])
    elif isinstance(static, (list, tuple)):
        for s, t in zip(static, tree):
            _copy_into(s, t)


def pool_bytes(pool) -> int:
    """The bytes reserved in the private memory pool ``pool`` (a
    ``CUDAGraph.pool()``), from the allocator's snapshot."""
    pool = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


class _Graph:
    __slots__ = ("generator", "graph", "static", "out", "launches", "grads")

    def __init__(self, generator):
        self.generator = generator  # held, so the key's id stays its own
        self.graph = None


class StepGraphs:
    """The captured graphs of one step function over ``params``.
    ``graphs(rec, key, body, state, inputs)`` runs
    ``body(state, inputs) -> (state, outputs)`` as the module docstring
    says, ``rec`` the step's open record; a replay advances
    ``state.step`` as the body does."""

    def __init__(self, params):
        self.params = list(params)
        self.graphs: dict = {}
        self.last = None  # the graph that replayed last
        _LIVE.add(self)

    def __call__(self, rec: dict, key, body, state, inputs):
        key = (key, id(state.generator))
        g = self.graphs.get(key)
        if g is None and len(self.graphs) >= MAX_GRAPHS:
            return body(state, inputs)
        if g is None:
            rec["path"] = "warmup"
            out = self._warmup(body, state, inputs, self.params[0].device)
            self.graphs[key] = _Graph(state.generator)
            return out
        if g.graph is None:
            rec["path"] = "capture"
            return self._capture(g, rec, body, state, inputs)
        rec["path"] = "replay"
        with profiling.phase("replay"):
            return self._replay(g, state, inputs)

    @staticmethod
    def _warmup(body, state, inputs, device):
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = body(state, inputs)
        main.wait_stream(side)
        return out

    def _capture(self, g: _Graph, rec: dict, body, state, inputs):
        for p in self.params:  # the warm-up's gradients, freed before
            p.grad = None
        g.static = _clone(inputs)
        torch.cuda.empty_cache()  # the warm-up's blocks, not held twice
        before = dict(_cuda.launches)
        graph = torch.cuda.CUDAGraph()
        if state.generator.device.type == "cuda":
            graph.register_generator_state(state.generator)
        with torch.cuda.graph(graph):
            state, out = body(state, g.static)
        g.launches = {k: n - before[k] for k, n in _cuda.launches.items()
                      if n != before[k]}
        g.graph, g.out = graph, out
        g.grads = [p.grad for p in self.params]
        rec["pool_bytes"] = pool_bytes(graph.pool())
        rec["reserved_bytes"] = torch.cuda.memory_reserved(
            self.params[0].device)
        graph.replay()
        self.last = g
        return state, _clone(out)

    def _replay(self, g: _Graph, state, inputs):
        _copy_into(g.static, inputs)
        g.graph.replay()
        for k, n in g.launches.items():
            _cuda.launches[k] += n
        if any(p.grad is not grad for p, grad in zip(self.params, g.grads)):
            for p, grad in zip(self.params, g.grads):  # after an eager step
                p.grad = grad
        self.last = g
        state.step += 1
        return state, _clone(g.out)
