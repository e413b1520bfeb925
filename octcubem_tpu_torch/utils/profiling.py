"""FLOPs / parameter profiling (counterpart of
octcubem_tpu/utils/profiling.py), and the program's step records and
spans.

Parity target: retinal-COEM/src/training/profile.py (fvcore
FlopCountAnalysis + ActivationCountAnalysis over the model registry, CSV
output).  The JAX package reads XLA's cost analysis of the compiled
program (FLOPs and bytes accessed); the port counts FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` over one eager call.  Torch
has no counterpart of XLA's "bytes accessed" (eager ops are not fused
into one program whose traffic a compiler could add up), so the port
reports none rather than invent a figure.  ``profiler`` records a
``torch.profiler`` trace (CPU and, on the card, CUDA activity) as a
Chrome trace.

Step records and spans.  ``step(engine)`` wraps one call of an engine's
step (or one served request) and ``phase(name)`` a part of it; on the
step's exit ``{"engine", "phases": {name: host seconds}, "seconds",
"profiled", "path", "seq"}`` joins ``RECORDS``, the last ``MAX_RECORDS``
steps of the process.  ``path`` is ``eager`` unless the step says
otherwise: a step replayed from a captured CUDA graph
(``train/step_graph.py``) is ``replay``, its first two calls ``warmup``
and ``capture``, and the capture's record holds ``pool_bytes``, the
graph's private memory pool.  Phases may nest (``update`` holds ``reduce`` and
``adamw``; the MAE step's ``forward`` holds ``premask`` and ``branch2d``);
outside a step a phase does nothing.  Host time is
``perf_counter_ns`` and is always taken.  While a ``torch.profiler``
session records (the one check is ``_profiler_enabled``), the step and
each phase also open a range ``octcube.<engine>.<name>`` (a user
annotation, on the device trace's clock); nothing else is entered,
formatted or added to an autograd graph otherwise.  ``backward(loss)``
puts the step's ``backward`` range on the thread that runs the backward
(on CUDA autograd's device thread, not the caller's), and
``attention(fn, qkv, num_heads, ...)`` wraps the attention op in
``octcube.attn.fwd`` / ``octcube.attn.bwd`` and writes each call's
(batch, heads, tokens, head_dim) into the profiled step's record under
``attn_fwd`` / ``attn_bwd``.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import functools
import itertools
import os
import statistics
import threading
import time
from typing import Callable

import torch
from torch.autograd import Variable
from torch.autograd.profiler import record_function


def param_count(params) -> int:
    """Elements over every parameter: a module, or a mapping / iterable
    of tensors or arrays."""
    if isinstance(params, torch.nn.Module):
        leaves = list(params.parameters())
    elif isinstance(params, dict):
        leaves = list(params.values())
    else:
        leaves = list(params)
    n = 0
    for p in leaves:
        size = 1
        for s in p.shape:
            size *= int(s)
        n += size
    return n


def flop_count(fn: Callable, *args) -> dict:
    """FLOPs of one call ``fn(*args)``, counted by ``FlopCounterMode``
    (matmuls, convolutions and attention products; elementwise ops are
    not counted) -> {"flops": total}.  The call runs."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops())}


def vit_flops(n_tokens: int, depth: int, d: int, mlp_ratio: float = 4.0) -> float:
    """Analytic fwd FLOPs of a pre-LN ViT stack (matmul terms)."""
    lin = 2 * n_tokens * (4 + 2 * mlp_ratio) * d * d
    attn = 4 * n_tokens * n_tokens * d
    return depth * (lin + attn)


def profile_models(entries: list[tuple[str, Callable, tuple]],
                   csv_path: str | None = None) -> list[dict]:
    """entries: [(name, fn, example_args)] -> per-model rows with the
    counted GFLOPs; optionally writes a CSV like the reference profiler."""
    rows = []
    for name, fn, args in entries:
        cost = flop_count(fn, *args)
        rows.append({"model": name,
                     "flops_G": round(cost["flops"] / 1e9, 3)})
    if csv_path and rows:
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    return rows


def profiler(log_dir: str):
    """A ``torch.profiler.profile`` of CPU activity, and CUDA activity when
    a card is present, whose trace is written to
    ``log_dir/trace.json`` (Chrome trace format) when it stops."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)

    def write(prof):
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

    return profile(activities=activities, on_trace_ready=write)


# ------------------------------------------------ step records and spans

MAX_RECORDS = 4096
RECORDS: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_SEQ = itertools.count(1)
_local = threading.local()   # .rec: the open step's record on this thread
recording = torch._C._autograd._profiler_enabled


def _range(name: str):
    rf = record_function(name)
    rf.__enter__()
    return rf


class step:
    """``with step(engine) as rec``: one step's record (module docstring);
    appended to ``RECORDS`` when the block exits without an exception."""

    __slots__ = ("engine", "rec", "outer", "rf", "t0")

    def __init__(self, engine: str):
        self.engine = engine

    def __enter__(self) -> dict:
        traced = recording()
        self.outer = getattr(_local, "rec", None)
        self.rec = rec = {"engine": self.engine, "phases": {},
                          "profiled": traced, "path": "eager"}
        self.rf = _range(f"octcube.{self.engine}.step") if traced else None
        _local.rec = rec
        self.t0 = time.perf_counter_ns()
        return rec

    def __exit__(self, exc_type, exc, tb):
        rec = self.rec
        rec["seconds"] = (time.perf_counter_ns() - self.t0) * 1e-9
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _local.rec = self.outer
        if exc_type is None:
            rec["seq"] = next(_SEQ)
            RECORDS.append(rec)
        return False


def stepped(engine: str):
    """Decorator: each call of the function is one ``step(engine)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with step(engine):
                return fn(*args, **kw)
        return call
    return wrap


class phase:
    """``with phase(name)``: adds the block's host seconds to the open
    step's record under ``name`` and, while a profiler records, runs it in
    the range ``octcube.<engine>.<name>`` (``span=False``: no range here,
    as for ``backward``, whose range ``backward()`` puts on autograd's
    thread).  ``on=False``, or no open step: nothing."""

    __slots__ = ("name", "on", "span", "rec", "rf", "t0")

    def __init__(self, name: str, on: bool = True, span: bool = True):
        self.name, self.on, self.span = name, on, span

    def __enter__(self):
        rec = self.rec = getattr(_local, "rec", None) if self.on else None
        if rec is not None:
            self.rf = (_range(f"octcube.{rec['engine']}.{self.name}")
                       if self.span and rec["profiled"] else None)
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        rec = self.rec
        if rec is not None:
            dt = (time.perf_counter_ns() - self.t0) * 1e-9
            phases = rec["phases"]
            phases[self.name] = phases.get(self.name, 0.0) + dt
            if self.rf is not None:
                self.rf.__exit__(None, None, None)
        return False


def span(name: str):
    """The range ``octcube.<engine>.<name>`` around a block of a profiled
    step, which adds nothing to the record (the COEM step's cached pass,
    inside ``forward``); else a context that does nothing."""
    rec = getattr(_local, "rec", None)
    if rec is None or not rec["profiled"]:
        return contextlib.nullcontext()
    return record_function(f"octcube.{rec['engine']}.{name}")


class _BackwardRange(torch.autograd.Function):
    """Identity on the tensor a backward starts from: its backward, the
    first node to run, opens the step's ``backward`` range on the thread
    that runs the backward and makes the step's record that thread's
    current one (so a rematerialised attention call there is counted); a
    callback at the backward's end closes both."""

    @staticmethod
    def forward(ctx, x, rec):
        ctx.rec = rec
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        rec, outer = ctx.rec, getattr(_local, "rec", None)
        rf = _range(f"octcube.{rec['engine']}.backward")
        _local.rec = rec

        def close():
            rf.__exit__(None, None, None)
            _local.rec = outer

        Variable._execution_engine.queue_callback(close)
        return g, None


def backward(t: torch.Tensor) -> torch.Tensor:
    """``t``, the tensor handed to ``autograd.grad`` / ``backward``, with the
    backward range's node on it while a profiler records inside a step."""
    rec = getattr(_local, "rec", None)
    if rec is None or not rec["profiled"]:
        return t
    return _BackwardRange.apply(t, rec)


class _AttnBwdOpen(torch.autograd.Function):
    """Identity on the attention op's output: its backward opens
    ``octcube.attn.bwd`` and counts the call."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = shape
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        rec = getattr(_local, "rec", None)
        if rec is not None:
            rec.setdefault("attn_bwd", []).append(ctx.shape)
        stack = getattr(_local, "attn", None)
        if stack is None:
            stack = _local.attn = []
        stack.append(_range("octcube.attn.bwd"))
        return g, None


class _AttnBwdClose(torch.autograd.Function):
    """Identity on the attention op's input: its backward, the op's last
    node, closes ``octcube.attn.bwd``."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        stack = getattr(_local, "attn", None)
        if stack:
            stack.pop().__exit__(None, None, None)
        return g


def attention(fn, qkv, num_heads: int, *args):
    """``fn(qkv, num_heads, *args)``, the fused-QKV attention op, inside
    ``octcube.attn.fwd``, its backward inside ``octcube.attn.bwd`` (every
    node autograd runs between the op's output and its input), the call's
    (batch, heads, tokens, head_dim) written into the open step's record.
    Called only while a profiler records."""
    b, n, hd3 = qkv.shape
    shape = (b, num_heads, n, hd3 // 3 // num_heads)
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.setdefault("attn_fwd", []).append(shape)
    track = torch.is_grad_enabled() and qkv.requires_grad
    if track:
        qkv = _AttnBwdClose.apply(qkv)
    with record_function("octcube.attn.fwd"):
        out = fn(qkv, num_heads, *args)
    return _AttnBwdOpen.apply(out, shape) if track else out


def records_since(seq: int = 0) -> list:
    """The kept records after sequence number ``seq``, oldest first."""
    return [r for r in list(RECORDS) if r["seq"] > seq]


def last_seq() -> int:
    recs = list(RECORDS)
    return recs[-1]["seq"] if recs else 0


TRAIN_PHASES = ("forward", "backward", "update", "reduce", "adamw")


def phase_medians_ms(records, names=TRAIN_PHASES):
    """{phase: median host ms over ``records``} for the phases of ``names``
    they hold."""
    return {n: statistics.median(r["phases"][n] for r in records
                                 if n in r["phases"]) * 1e3
            for n in names if any(n in r["phases"] for r in records)}


def range_device_ms(prof, prefix: str = "octcube.") -> dict:
    """{range name: device ms} of a finished ``torch.profiler`` session
    with CUDA activity: the kernels and copies launched inside each range
    whose name starts with ``prefix``, on the range's thread."""
    out: dict = {}
    for e in prof.events():
        if e.name.startswith(prefix) and e.device_type == \
                torch.autograd.DeviceType.CPU:
            out[e.name] = out.get(e.name, 0.0) + e.device_time_total / 1e3
    return out
