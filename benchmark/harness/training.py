"""What the training drivers share: the pinned host pool the feed copies
from, the measured window of back-to-back steps, the profiled stretch,
and the readings of the program's state that the comparison takes."""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from . import probes
from .core import train_gaps
from .profiling import Stretch, profiled


def host_pool(make_batch, count: int, device, items=None):
    """``count`` batches made on the device by ``make_batch(i)`` (a dict of
    tensors; with ``items``, ``make_batch(item)`` of each), each copied
    into pinned host memory -> list of dicts."""
    pool = []
    items = iter(range(count) if items is None else items)
    for _ in range(count):
        b = make_batch(next(items))
        host = {}
        for k, t in b.items():
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=(
                device.type == "cuda"))
            h.copy_(t)
            host[k] = h
        del b
        pool.append(host)
    return pool


def volumes(shape, gen, device):
    """Seeded volumes or images [N, ...] on the device: uniform noise, each
    sample at its own brightness and contrast (an offset in [0, 0.3) and a
    span in [0.3, 1.0)), as scans from different devices and eyes differ."""
    n, rest = shape[0], (1,) * (len(shape) - 1)
    lo = 0.3 * torch.rand((n, *rest), generator=gen, device=device)
    span = 0.3 + 0.7 * torch.rand((n, *rest), generator=gen, device=device)
    return lo + span * torch.rand(shape, generator=gen, device=device)


def to_device(batch: dict, device) -> dict:
    return {k: t.to(device, non_blocking=True) for k, t in batch.items()}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def measure_window(run, feed, call, samples_per_step: int) -> None:
    """Back-to-back steps for ``run.seconds``: the window runs from the
    first step's issue to the synchronize after the last step that started
    before the time ran out.  ``feed(i)`` -> the step's inputs (copied
    to the card, outside the step's span); ``call(inputs)`` -> the step's
    0-d loss tensor.  Fills ``run.window`` and the ``issue`` spans."""
    dev = run.device
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's full passes
    run.setup_done()
    losses, i = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        inputs = feed(i)
        t = time.perf_counter()
        losses.append(call(inputs))
        run.span("issue", time.perf_counter() - t)
        i += 1
    sync(dev)
    t1 = time.perf_counter()
    if dev.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated()
    vals = torch.stack([x.float() for x in losses]).cpu().tolist()
    run.attempted = i
    run.failed = sum(1 for v in vals if not math.isfinite(v))
    run.window = {"seconds": t1 - t0, "steps": i,
                  "samples": i * samples_per_step, "last_loss": vals[-1]}


def stretch(run, feed, call, tx, layers_module, steps: int,
            start: int = 0) -> None:
    """``steps`` more steps under the profiler, the harness's ranges
    around each step, the optimizer and the attention op."""
    with probes.attention(layers_module) as att, probes.optimizer(tx):
        def body():
            from torch.autograd.profiler import record_function

            for i in range(steps):
                inputs = feed(start + i)
                with record_function("bench.step"):
                    call(inputs)
        tr = profiled(run, body)
    run.profile = Stretch(tr, steps, att)


@torch.no_grad()
def leaf_norms(tensors, names) -> dict:
    """{name: fp64 norm} of a list of tensors, read in one copy."""
    norms = torch.stack([t.double().norm() for t in tensors]).cpu().tolist()
    return dict(zip(names, norms))


def check_optimizer(tx, spec: dict) -> None:
    """Raise unless the program's AdamW is the configuration's."""
    from reference import adamw

    lr = adamw.schedule(spec["lr"])
    ours = (list(spec["betas"]), spec["eps"], spec["weight_decay"],
            [lr(i) for i in range(4)])
    theirs = ([tx.b1, tx.b2], tx.eps, tx.weight_decay,
              [tx.lr(i) for i in range(4)])
    if ours != theirs:
        raise RuntimeError(f"the program's AdamW {theirs} is not the "
                           f"configuration's {ours}")


@torch.no_grad()
def moving_entries(grads: dict, share: float = 1e-3) -> dict:
    """{leaf: mask of the entries whose reference gradient is at least
    ``share`` of the median leaf's RMS}.  The others (the key third of a
    fused q/k/v bias under the softmax, a leaf the loss does not use) move
    under Adam by round-off alone, and are left out of the change."""
    rms = torch.stack([g.double().norm() / g.numel() ** 0.5
                       for g in grads.values()]).cpu().tolist()
    floor = share * statistics.median(rms)
    return {n: g.abs() >= floor for n, g in grads.items()}


@torch.no_grad()
def change_norms(delta: dict, keep: dict, device) -> dict:
    """{leaf: fp64 norm of its change over the kept entries}, for the
    leaves with an entry kept; ``delta`` may sit on the host."""
    names = [n for n, k in keep.items() if bool(k.any())]
    norms = torch.stack([delta[n].to(device)[keep[n]].double().norm()
                         for n in names]).cpu().tolist()
    return dict(zip(names, norms))


def left_out(keep: dict) -> str:
    """What ``moving_entries`` left out, for the run's notes."""
    counts = {n: int((~k).sum()) for n, k in keep.items()}
    total = sum(counts.values())
    most = sorted(((c / keep[n].numel(), n) for n, c in counts.items()
                   if c), reverse=True)[:4]
    return (f"{total} entries left out of the change (reference gradient "
            f"under 1e-3 of the median leaf's RMS); most in " + ", ".join(
                f"{n} ({share:.1%})" for share, n in most))


def feature_gap(prog, ref) -> float:
    """The largest gap of a row of features, over the reference row's
    norm: ``prog`` and ``ref`` are lists of [rows, width] tensors (one a
    tower)."""
    if prog is None or len(prog) != len(ref) or any(
            p.shape != r.shape for p, r in zip(prog, ref)):
        return math.inf
    gap = max(float(((p.to(r.device) - r).norm(dim=-1)
                     / r.norm(dim=-1)).max()) for p, r in zip(prog, ref))
    return gap if math.isfinite(gap) else math.inf


def gaps(side: dict, ref: dict, device) -> dict:
    """``train_gaps`` of one side against the reference, each side's change
    taken over the entries that the reference's first gradient moves.
    A side gives {"losses", "grad": {leaf: norm}, "delta": {leaf: change
    after the followed steps}, and optionally "features"}; the reference
    also "keep" (``moving_entries``)."""
    if set(side["grad"]) != set(ref["grad"]):
        raise RuntimeError("the program's leaves are not the reference's: "
                           f"{sorted(set(side['grad']) ^ set(ref['grad']))}")
    keep = ref["keep"]
    out = train_gaps(dict(side, change=change_norms(side["delta"], keep,
                                                    device)),
                     dict(ref, change=change_norms(ref["delta"], keep,
                                                   device)))
    if "features" in ref:
        out["feature_gap"] = feature_gap(side.get("features"),
                                         ref["features"])
    return out


def compare(run, ours: dict, ref: dict) -> dict:
    g = gaps(ours, ref, run.device)
    run.note(f"worst leaves: first gradient {g['grad_leaf']}, change "
             f"{g['change_leaf']}; {left_out(ref['keep'])}")
    run.note(f"losses: program {ours['losses']}, reference {ref['losses']}")
    run.note("gaps: " + ", ".join(f"{k} {g[k]!r}" for k in (
        "loss_gap", "grad_gap", "grad_median_gap", "change_gap",
        "change_median_gap", "feature_gap") if k in g))
    for k, lim in run.workload["limits"].items():
        run.check(k, g[k], lim)
    return g
