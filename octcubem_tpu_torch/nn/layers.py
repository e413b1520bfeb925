"""Transformer building blocks (counterpart of octcubem_tpu/nn/layers.py).

Parameter names follow the reference flash-attn block state dict
(blocks.i.{norm1, mixer.Wqkv, mixer.out_proj, norm2, mlp.fc1, mlp.fc2}),
so reference checkpoints and ``compat.jax_params.state_dict_from_jax``
load with ``load_state_dict(strict=True)``.

The dtype flow is the flax one: LayerNorms compute and return fp32;
every Dense casts its input, weight and bias to the compute dtype; the
residual stream stays in the compute dtype.  ``Block`` returns
``(hidden, mlp_branch)``: with ``parity="flash"`` the stack's final
feature is the last block's MLP branch, without the final residual add
(the reference flash-attn two-stream block).

Rematerialisation, as in the JAX package: ``TransformerStack(remat=True)``
runs each block under non-reentrant ``torch.utils.checkpoint`` (its
activations are recomputed in the backward, the attention kernel's
forward included); ``remat_norm`` checkpoints only a block's two
LayerNorms, and only when ``remat`` is off.  Both act only while autograd
records.  Drop-path masks come from an explicit ``torch.Generator``,
which checkpoint's RNG preservation does not cover: a checkpointed block
draws from a copy of the generator set to the state it had before the
block, in the forward and again in the recompute, and the generator is
then advanced to where the copy ended, so remat on and off draw the same
masks.  Parameter names do not change.

``quant=True`` (int8 serving, ops/quant.py) swaps the four block
projections for ``QuantDense``, whose ``weight_q`` / ``scale`` buffers
``ops.quant.quantize_state_dict`` writes; attention stays in the compute
dtype.  ``TransformerStack(capture_cam=True)`` keeps, after every block,
the activation Grad-CAM reads (utils/saliency.py) and, while autograd
records, adds to it a zero tensor that requires grad (the JAX package's
flax ``perturb``): its gradient is dScore/dActivation even when every
parameter is frozen, as in serving.  With ``parity="flash"`` the last
block's point is its MLP branch, the tensor that carries the signal.

The parallel paths.  Under ``attn_impl="flash_tp"`` (parallel/tensor.py)
``MHA`` and ``Mlp`` hold this rank's shards (``shard_tp_params``):
``Wqkv`` and ``fc1`` are column-parallel, ``out_proj`` and ``fc2``
row-parallel with the forward all-reduce, their biases added once after
it.  Under ``attn_impl="flash_sp"`` the attention takes token shards; a
``TransformerStack`` run inside ``use_sequence_parallel(...,
shard_stacks=True)`` takes the global activations, as a JAX model does,
and shards them on entry and gathers them on exit
(``parallel/sequence.run_stack_sharded``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import multi_head_attention_qkv
from ..ops.quant import int8_matmul

LN_EPS = 1e-6


class Dense(nn.Linear):
    """nn.Linear that casts input, weight and bias to ``compute_dtype``
    (flax ``nn.Dense(dtype=...)``); the parameters stay fp32."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class QuantDense(nn.Module):
    """Int8 Dense of the serving path: ``weight_q`` int8 [out, in] and
    ``scale`` fp32 [out] (buffers: no gradient, zeros and ones until a
    quantized state dict is loaded), the bias a parameter; the input is
    cast to ``compute_dtype`` and quantized per token (ops/quant.py)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.register_buffer("weight_q", torch.zeros(
            (out_features, in_features), dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        y = int8_matmul(x.to(self.compute_dtype), self.weight_q, self.scale)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics and fp32 output (flax
    ``nn.LayerNorm(dtype=float32)``)."""

    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


def dropout(x, rate: float, generator: torch.Generator | None = None,
            shape: tuple[int, ...] | None = None):
    """Inverted dropout drawing its mask, of ``shape`` (broadcast over x;
    default x's shape), from ``generator``."""
    keep = 1.0 - rate
    mask = torch.rand(shape or x.shape, generator=generator,
                      device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth on a residual branch; active only in
    training mode."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: torch.Generator | None = None):
        if self.rate == 0.0 or not self.training:
            return x
        return dropout(x, self.rate, generator,
                       shape=(x.shape[0],) + (1,) * (x.ndim - 1))


def _row_parallel(dense: Dense, x, group):
    """A row-parallel projection: this rank's partial product, summed over
    the tp group, then the bias once (one rank: the plain projection)."""
    from ..parallel.tensor import reduce_from_tp

    if dist.get_world_size(group) == 1:
        return dense(x)
    dt = dense.compute_dtype
    y = reduce_from_tp(F.linear(x.to(dt), dense.weight.to(dt)), group)
    return y if dense.bias is None else y + dense.bias.to(dt)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2; with ``tp`` (a ``flash_tp`` block's) fc1
    is column- and fc2 row-parallel over the tp context's group."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32, quant: bool = False,
                 tp: bool = False):
        super().__init__()
        dense = QuantDense if quant else Dense
        self.tp = tp
        self.fc1 = dense(in_dim, hidden_dim, compute_dtype=dtype)
        self.fc2 = dense(hidden_dim, out_dim, compute_dtype=dtype)

    def forward(self, x):
        if self.tp:
            from ..parallel.tensor import copy_to_tp, tp_group

            group = tp_group()[0]
            return _row_parallel(self.fc2, F.gelu(self.fc1(
                copy_to_tp(x, group))), group)
        return self.fc2(F.gelu(self.fc1(x)))  # exact erf GELU


class MHA(nn.Module):
    """Fused-QKV multi-head attention ('mixer' in flash-attn naming)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 quant: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        dense = QuantDense if quant else Dense
        self.Wqkv = dense(dim, 3 * dim, bias=qkv_bias, compute_dtype=dtype)
        self.out_proj = dense(dim, dim, compute_dtype=dtype)

    def forward(self, x):
        if self.attn_impl == "flash_tp":
            from ..parallel.tensor import copy_to_tp, tp_group

            group = tp_group()[0]
            out = multi_head_attention_qkv(self.Wqkv(copy_to_tp(x, group)),
                                           self.num_heads, impl="flash_tp")
            return _row_parallel(self.out_proj, out, group)
        qkv = self.Wqkv(x)
        out = multi_head_attention_qkv(qkv, self.num_heads,
                                       impl=self.attn_impl)
        return self.out_proj(out)


class Block(nn.Module):
    """Pre-LN transformer block; returns (hidden, mlp_branch).
    ``remat_norm``: the LayerNorms' fp32 outputs are recomputed in the
    backward instead of saved."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 remat_norm: bool = False, quant: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat_norm = remat_norm
        self.norm1 = LayerNorm(dim)
        self.mixer = MHA(dim, num_heads, qkv_bias, dtype, attn_impl, quant)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype, quant,
                       tp=attn_impl == "flash_tp")
        self.drop_path2 = DropPath(drop_path)

    def _norm(self, norm: LayerNorm, x):
        if self.remat_norm and torch.is_grad_enabled():
            return checkpoint(norm, x, use_reentrant=False)
        return norm(x)

    def forward(self, x, generator: torch.Generator | None = None):
        a = self.mixer(self._norm(self.norm1, x).to(self.dtype))
        x = x + self.drop_path1(a, generator)
        m = self.drop_path2(self.mlp(self._norm(self.norm2, x).to(self.dtype)),
                            generator)
        return x + m, m


def _checkpointed(blk: Block, x, generator: torch.Generator | None):
    """``blk(x, generator)`` under non-reentrant checkpoint, its drop-path
    draws replayed in the recompute (see the module docstring).  A block
    that draws nothing (no drop path, or eval mode) gets no generator and
    no copy of it; one that draws refuses a CUDA graph's capture
    (train/step_graph.py), where no generator can be made, before it
    touches anything."""
    draws = blk.training and (blk.drop_path1.rate or blk.drop_path2.rate)
    if generator is None or not draws:
        return checkpoint(blk, x, None, use_reentrant=False)
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a checkpointed block with drop path cannot be "
                           "captured: its recompute needs a new generator")
    start = generator.get_state()
    copies = []

    def run(x):
        g = torch.Generator(device=generator.device)
        g.set_state(start)
        copies.append(g)
        return blk(x, g)

    out = checkpoint(run, x, use_reentrant=False)
    generator.set_state(copies[0].get_state())
    return out


class TransformerStack(nn.ModuleList):
    """Blocks with linearly increasing drop-path and the final-feature
    selection: parity='flash' -> the last block's MLP branch (released
    flash-attn checkpoints), parity='standard' -> the full hidden state.
    Children are named 0..depth-1, so keys read blocks.{i}.*.  ``remat``:
    each block is checkpointed; ``remat_norm`` (without ``remat``): each
    block's LayerNorms.  ``capture_cam``: after a forward, ``cam`` holds
    one (activation, zero perturbation or None) pair per block (see the
    module docstring)."""

    def __init__(self, depth: int, dim: int, num_heads: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 parity: str = "flash", remat: bool = False,
                 remat_norm: bool = False, quant: bool = False,
                 capture_cam: bool = False):
        if parity not in ("flash", "standard"):
            raise ValueError(f"unknown parity {parity!r}")
        dpr = ([drop_path_rate * i / (depth - 1) for i in range(depth)]
               if depth > 1 else [0.0])
        super().__init__([
            Block(dim, num_heads, mlp_ratio, qkv_bias, dpr[i], dtype,
                  attn_impl, remat_norm=remat_norm and not remat, quant=quant)
            for i in range(depth)])
        self.parity = parity
        self.remat = remat
        self.capture_cam = capture_cam
        self.cam: list = []

    def _cam_point(self, t):
        """Record ``t`` as a Grad-CAM activation, plus a zero perturbation
        that requires grad while autograd records."""
        pert = None
        if torch.is_grad_enabled():
            pert = torch.zeros_like(t, requires_grad=True)
            t = t + pert
        self.cam.append((t, pert))
        return t

    def forward(self, x, generator: torch.Generator | None = None,
                return_hidden: bool = False):
        """-> the final feature, or with ``return_hidden`` the list of
        every block's: its MLP branch under parity="flash" (as the
        final feature is), its hidden state under "standard"."""
        if len(self) and self[0].mixer.attn_impl == "flash_sp":
            from ..parallel.sequence import run_stack_sharded, shards_stacks

            if shards_stacks():
                return run_stack_sharded(
                    lambda t: self._forward(t, generator, return_hidden), x)
        return self._forward(x, generator, return_hidden)

    def _forward(self, x, generator, return_hidden):
        m = x
        remat = self.remat and torch.is_grad_enabled()
        if self.capture_cam:
            self.cam = []
        hidden = []
        for i, blk in enumerate(self):
            x, m = (_checkpointed(blk, x, generator) if remat
                    else blk(x, generator))
            if self.capture_cam:
                if i == len(self) - 1 and self.parity == "flash":
                    m = self._cam_point(m)
                else:
                    x = self._cam_point(x)
            if return_hidden:
                hidden.append(m if self.parity == "flash" else x)
        if return_hidden:
            return hidden
        return m if self.parity == "flash" else x
