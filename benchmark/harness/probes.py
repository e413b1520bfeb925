"""The harness's own spans around calls into the program's layers, put in
for the profiled stretch only, so the measured window runs the program
as it is.

- ``attention(layers_module)``: the fused-QKV attention op that every
  block of the ViT trunks calls (``nn/layers.py``'s
  ``multi_head_attention_qkv``) runs inside a ``bench.attn_fwd`` range,
  and its backward inside ``bench.attn_bwd``: an identity autograd node
  on the op's output opens the backward range and one on its input
  closes it, so every node the engine runs between them (the kernels'
  backward, the cls row's, the concatenation's) is the op's backward.
  Each call records its (batch, heads, tokens, head_dim), forward and
  backward apart, for the roofline readers.
- ``optimizer(tx)``: ``tx.step`` runs inside a ``bench.optimizer`` range.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.autograd.profiler import record_function

_local = threading.local()


class _OpenBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape, calls):
        ctx.shape, ctx.calls = shape, calls
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.calls.append(ctx.shape)
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rf = record_function("bench.attn_bwd")
        rf.__enter__()
        stack.append(rf)
        return g, None, None


class _CloseBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        stack = getattr(_local, "stack", None)
        if stack:
            stack.pop().__exit__(None, None, None)
        return g


class AttentionProbe:
    def __init__(self):
        self.fwd: list = []   # (b, h, n, d) per forward call
        self.bwd: list = []   # (b, h, n, d) per backward call


@contextlib.contextmanager
def attention(layers_module):
    """Wrap ``layers_module.multi_head_attention_qkv`` -> an
    ``AttentionProbe`` filled while the block runs."""
    probe = AttentionProbe()
    orig = layers_module.multi_head_attention_qkv

    def wrapped(qkv, num_heads, *args, **kw):
        b, n, hd3 = qkv.shape
        shape = (b, num_heads, n, hd3 // 3 // num_heads)
        probe.fwd.append(shape)
        track = torch.is_grad_enabled() and qkv.requires_grad
        if track:
            qkv = _CloseBwd.apply(qkv)
        with record_function("bench.attn_fwd"):
            out = orig(qkv, num_heads, *args, **kw)
        if track:
            out = _OpenBwd.apply(out, shape, probe.bwd)
        return out

    layers_module.multi_head_attention_qkv = wrapped
    try:
        yield probe
    finally:
        layers_module.multi_head_attention_qkv = orig


@contextlib.contextmanager
def optimizer(tx):
    """Run ``tx.step`` inside a ``bench.optimizer`` range."""
    orig = tx.step

    def step(*args, **kw):
        with record_function("bench.optimizer"):
            return orig(*args, **kw)

    tx.step = step
    try:
        yield
    finally:
        del tx.step
