"""Sequence parallelism for long-token attention over ``torch.distributed``
(counterpart of octcubem_tpu/parallel/sequence.py).

Queries shard over the ``sp`` axis of a ``DeviceMesh`` (``core/mesh.py``):
each rank gathers the key/value set of its sp group and runs the
rectangular flash kernels on its query slice.  Memory per rank: O(N/sp)
for q and the output, O(N) for the gathered k/v (transient); the ring
form keeps k/v at O(N/sp) in both directions of autodiff.

The sharding rule.  The JAX package's functions see global arrays and
pad at trace time; a rank here sees only its shard, so the rule is
explicit:
- Activations are token-sharded and stay so; only attention gathers.
  Rank r of an sp group of n_sp ranks holds rows [r * n_loc, (r + 1) *
  n_loc) of the sequence padded with zero rows to n_sp * n_loc.
  ``shard_sequence`` pads a global tensor that way and returns the rank's
  shard.
- The global valid length (the unpadded n) is carried explicitly: the
  ``n_valid`` argument of ``sequence_parallel_attention``, or the
  ``n_valid`` of the ``use_sequence_parallel`` context for the model path
  (attn_impl="flash_sp", ``ops/attention.py``).  Keys at or past it are
  zeroed (so their gradient is 0) and masked out of every query's
  softmax.  Pad query rows come out with values the caller drops; a loss
  that reads only valid rows gives them a zero gradient, so they add
  nothing to any parameter's gradient.
- With ``batch_axis``, the batch is split over that mesh axis: each rank
  holds its own batch slice, and the sp group (``mesh.get_group(axis)``)
  is the ranks that share it.

Backward: the gather's transpose is a reduce-scatter (sum) of dk/dv over
the sp group (``core/multihost.all_gather_with_grad``, which gloo ranks
on a card also run); JAX derives it from ``all_gather``.  The ring's
backward re-rotates k/v with their gradient accumulators, as the JAX
custom VJP does; gloo sends CPU tensors only, so a ring of gloo ranks on
a card stages its blocks through the host.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.multihost import all_gather_with_grad
from ..ops.flash_attention import (_delta_bh, bwd_bh, flash_attention_rect,
                                   fwd_bh)


def _sp_group(mesh, axis: str, batch_axis: str | None = None):
    """-> (process group of this rank's ``axis``, its size, this rank's
    index in it)."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r} (axes {names})")
    if batch_axis is not None and (batch_axis not in names
                                   or batch_axis == axis):
        raise ValueError(f"batch_axis {batch_axis!r} is not another axis of "
                         f"the mesh (axes {names})")
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _gather_kv(k, v, group):
    """The local k, v [B, H, n_loc, D] -> the group's full k, v
    [B, H, n_sp * n_loc, D] in rank order, by one all_gather of both
    (``core/multihost.all_gather_with_grad``: the backward reduce-scatters
    dk, dv back to their shards).  The gathered rows lie sequence-major
    ([N, 2, B, H, D] memory), so the [B, H, N, D] views reach the kernels
    with no copy."""
    local = torch.stack([k, v]).permute(3, 0, 1, 2, 4)
    full = all_gather_with_grad(local, group)
    kf, vf = full.permute(1, 2, 3, 0, 4).unbind(0)
    return kf, vf


def sequence_parallel_attention(q, k, v, mesh, axis: str = "sp",
                                scale: float | None = None,
                                no_max: bool = True,
                                n_valid: int | None = None,
                                batch_axis: str | None = None):
    """q, k, v: this rank's shards [B, H, n_loc, D] of a sequence of
    n_sp * n_loc rows -> its output shard [B, H, n_loc, D].
    Differentiable; dk / dv are reduce-scattered back to their shards.

    ``n_valid``: the global valid length when the sequence was padded to
    a multiple of the sp degree (``shard_sequence``); keys at or past it
    are zeroed and masked, pad query rows are the caller's to drop.  The
    rank runs ``flash_attention_rect(no_max=no_max, kv_valid=n_valid)`` on
    its queries against the gathered keys: B5 (``no_max=True``) or B6
    forward, B7 backward."""
    group, n_sp, r = _sp_group(mesh, axis, batch_axis)
    n_loc = q.shape[2]
    n = n_loc * n_sp
    if n_valid is not None and not 1 <= n_valid <= n:
        raise ValueError(f"n_valid {n_valid} not in [1, {n}]")
    if n_valid is not None and n_valid < n:
        rows = torch.arange(r * n_loc, (r + 1) * n_loc, device=k.device)
        keep = (rows < n_valid)[:, None]
        k = torch.where(keep, k, 0)
        v = torch.where(keep, v, 0)
    kf, vf = _gather_kv(k, v, group)
    return flash_attention_rect(q, kf, vf, scale=scale, no_max=no_max,
                                kv_valid=n_valid)


def _rotate(tensors, group, n_sp: int, r: int):
    """Send each tensor to the next rank of the ring and take the previous
    rank's (the JAX ppermute i -> i + 1); the identity for one rank, as a
    ppermute to itself is (``torch.distributed`` refuses a send to one's
    own rank)."""
    if n_sp == 1:
        return list(tensors)
    nxt = dist.get_global_rank(group, (r + 1) % n_sp)
    prv = dist.get_global_rank(group, (r - 1) % n_sp)
    host = dist.get_backend(group) == "gloo" and tensors[0].is_cuda
    send = [(t.cpu() if host else t).contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = ([dist.P2POp(dist.isend, t, nxt, group) for t in send]
           + [dist.P2POp(dist.irecv, t, prv, group) for t in recv])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recv, tensors)] if host else recv


class _RingAttention(torch.autograd.Function):
    """The ring over local [B, H, n_loc, D] shards.  Forward: n_sp steps,
    each B5 on the visiting (k, v) block, merged by logaddexp of the
    blocks' lse; (k, v) rotate between steps.  Backward: delta once, then
    per step B7 against the global (out, lse), which makes each pair's
    gradient an exact partial sum of the global softmax's, with (k, v,
    dk, dv) rotating together so that after the full cycle each dk / dv
    block is home with every query shard's share.  Only the local (q, k,
    v, out, lse) are saved: O(N/sp) memory for training."""

    @staticmethod
    def forward(ctx, q, k, v, group, n_sp: int, r: int, scale: float):
        out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(q.shape[:3], -math.inf, dtype=torch.float32,
                         device=q.device)
        kc, vc = k, v
        for step in range(n_sp):
            o_i, l_i = fwd_bh(q, kc, vc, None, None, scale)
            new_lse = torch.logaddexp(lse, l_i)
            out = (out * torch.exp(lse - new_lse)[..., None]
                   + o_i.float() * torch.exp(l_i - new_lse)[..., None])
            lse = new_lse
            if step + 1 < n_sp:
                kc, vc = _rotate((kc, vc), group, n_sp, r)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.n_sp, ctx.r, ctx.scale = group, n_sp, r, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, n_sp, r = ctx.group, ctx.n_sp, ctx.r
        # (dout, out, lse) never rotate: delta once, not once per step
        delta = _delta_bh(out, dout, None)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        kc, vc = k, v
        for step in range(n_sp):
            dq_p, dk_p, dv_p, _, _ = bwd_bh(q, kc, vc, None, None, out, lse,
                                            dout, None, ctx.scale,
                                            delta=delta)
            dq += dq_p.float()
            dk = dk + dk_p.float()
            dv = dv + dv_p.float()
            if step + 1 < n_sp:
                kc, vc, dk, dv = _rotate((kc, vc, dk, dv), group, n_sp, r)
            else:  # the accumulators' last hop home
                dk, dv = _rotate((dk, dv), group, n_sp, r)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def ring_attention(q, k, v, mesh, axis: str = "sp",
                   scale: float | None = None,
                   batch_axis: str | None = None):
    """Ring attention with O(N/sp) k/v memory per rank in both directions
    of autodiff.  q, k, v: this rank's shards [B, H, n_loc, D] -> its
    output shard.  Each rank's (k, v) block visits every rank of the sp
    group by point-to-point sends (``batch_isend_irecv``) while every
    query shard folds it into its softmax state through the kernel's lse
    (B5 forward, B7 backward; see ``_RingAttention``).  ``batch_axis`` as
    in ``sequence_parallel_attention``.  Second-order autodiff through the
    hand-written backward is not supported."""
    group, n_sp, r = _sp_group(mesh, axis, batch_axis)
    d = q.shape[-1]
    scale = float(d ** -0.5 if scale is None else scale)
    return _RingAttention.apply(q, k, v, group, n_sp, r, scale)


def shard_sequence(x, mesh, axis: str = "sp", dim: int = 2):
    """This rank's shard of a global ``x`` along ``dim`` over the mesh
    ``axis``: x zero-padded along ``dim`` to a multiple of the sp degree,
    rows [r * n_loc, (r + 1) * n_loc) of it (a view of the padded
    tensor).  The unpadded length is the caller's ``n_valid``."""
    _, n_sp, r = _sp_group(mesh, axis)
    n = x.shape[dim]
    pad = -n % n_sp
    if pad:
        widths = [0, 0] * (x.ndim - 1 - dim % x.ndim) + [0, pad]
        x = F.pad(x, widths)
    n_loc = (n + pad) // n_sp
    return x.narrow(dim, r * n_loc, n_loc)


# ---- model integration: attn_impl="flash_sp" -------------------------
#
# The attention dispatch (ops/attention.multi_head_attention_packed)
# reads the active (mesh, axis, batch_axis, n_valid) from this context,
# so models opt in with attn_impl="flash_sp" without threading a mesh
# through every module:
#
#     with use_sequence_parallel(mesh, "sp", n_valid=n):
#         out = stack(shard_sequence(x, mesh, dim=1))
#
# Everything around the attention (LayerNorm, MLP, projections) is
# token-wise and runs on the rank's shard as it is.
#
# A whole model (cli/pretrain.py with n_sp > 1) runs as the JAX model
# does, on global activations: under ``shard_stacks=True`` each
# ``TransformerStack`` with attn_impl="flash_sp" shards its input on
# entry, runs its blocks on the shard with the stack's own n_valid, and
# gathers its output on exit (``run_stack_sharded``).  The gather's
# backward is a reduce-scatter (sum) over the sp group, so the gradient
# of every parameter, inside the stacks and out, is a partial sum over
# the sp ranks whose total is sp-degree times the gradient; the mean over
# all ranks of the mesh (the data-parallel reduction, train/mae_engine.py)
# is then the exact gradient of the global loss.

_SP_CONTEXT: list[tuple] = []


@contextlib.contextmanager
def use_sequence_parallel(mesh, axis: str = "sp",
                          batch_axis: str | None = None,
                          n_valid: int | None = None,
                          shard_stacks: bool = False):
    """batch_axis: the mesh axis the batch is split over for the composed
    data x sp case (None: every sp group holds the same batch).  n_valid:
    the global valid length of a padded sequence (None: no pad).
    shard_stacks: the stacks take global activations and shard them
    (the module comment above)."""
    _SP_CONTEXT.append((mesh, axis, batch_axis, n_valid, shard_stacks))
    try:
        yield
    finally:
        _SP_CONTEXT.pop()


def current_sp() -> tuple:
    """-> (mesh, axis, batch_axis, n_valid) of the innermost context."""
    if not _SP_CONTEXT:
        raise RuntimeError(
            "attn_impl='flash_sp' requires an active use_sequence_parallel "
            "(mesh, axis) context when the attention runs")
    return _SP_CONTEXT[-1][:4]


def shards_stacks() -> bool:
    """Whether the innermost context asks the stacks to shard."""
    return bool(_SP_CONTEXT) and _SP_CONTEXT[-1][4]


def run_stack_sharded(fn, x):
    """``fn`` (a stack's blocks over token shards) on global activations x
    [B, N, C]: this rank's shard of x padded to a multiple of the sp
    degree, ``fn`` under the context with n_valid = N, its output (a
    tensor, or a list of them) gathered back to [B, N, C]."""
    mesh, axis, batch_axis, _ = current_sp()
    group, n_sp, _ = _sp_group(mesh, axis, batch_axis)
    n = x.shape[1]
    with use_sequence_parallel(mesh, axis, batch_axis, n_valid=n):
        out = fn(shard_sequence(x, mesh, axis, dim=1))

    def gather(t):
        if n_sp == 1:
            return t
        return all_gather_with_grad(t, group, dim=1)[:, :n]

    return [gather(t) for t in out] if isinstance(out, list) else gather(out)
