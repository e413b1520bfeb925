"""Checkpoint save / resume and latest-step discovery (counterpart of
octcubem_tpu/core/checkpoint.py, where orbax writes; here ``torch.save``).

A checkpoint directory holds one subdirectory per step, named by the step
number: ``<step>/state.pt`` (the state's ``state_dict()``, or a nested
dict of tensors and numbers, as host copies) and ``<step>/extra.json``
when metadata was given.  The JAX package's semantics:

- a save at a step at or below the latest one on disk is skipped;
- ``keep_last=N`` keeps the N highest steps after a save;
- ``async_save=True`` returns once complete host copies are staged (so the
  caller may update its tensors in place at once) and writes in a
  background thread; one save per directory is in flight, and each save,
  ``wait_for_saves`` and every reader below wait for it first;
- a step appears under its number only once fully written: it is written
  under a hidden temporary name and moved into place with ``os.replace``.

Files are read with ``weights_only=True``.

In a process group every rank holds the same replicated state: rank 0
alone writes (and deletes), the others return at once, and every
reader, ``wait_for_saves`` included, ends at a barrier once rank 0's
pending write is on disk, so no rank reads a step before it is
complete.  Every rank restores, and a resume on n ranks is bit-exact as
on one.  The calls are collective: every rank makes them in the same
order.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import re
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import torch

from .multihost import barrier, world

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"
EXTRA_FILE = "extra.json"

# one writer thread and the last save's future per directory (abs path);
# the lock guards both tables
_LOCK = threading.Lock()
_WRITERS: dict[str, ThreadPoolExecutor] = {}
_PENDING: dict[str, Future] = {}


def _host_copy(obj: Any) -> Any:
    """A state (anything with ``state_dict()``) or nested dict / list of
    tensors and numbers -> the same structure with every tensor copied to
    the host, sharing nothing with the live tensors."""
    if hasattr(obj, "state_dict") and callable(obj.state_dict):
        obj = obj.state_dict()
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir)
                  if re.fullmatch(r"\d+", n))


def _write(ckpt_dir: str, step: int, payload: Any, extra: dict | None,
           keep_last: int | None) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".{step}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)  # a crashed writer's leftover
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    if extra:
        with open(os.path.join(tmp, EXTRA_FILE), "w") as f:
            json.dump(extra, f)
    os.replace(tmp, os.path.join(ckpt_dir, str(step)))
    if keep_last is not None:
        steps = _steps(ckpt_dir)
        for old in steps[:max(0, len(steps) - keep_last)]:
            shutil.rmtree(os.path.join(ckpt_dir, str(old)), ignore_errors=True)


def wait_for_saves(ckpt_dir: str | None = None) -> None:
    """Block until the pending async save for ``ckpt_dir`` (or for every
    directory) is on disk; re-raises a failed write's error."""
    with _LOCK:
        if ckpt_dir is None:
            futures = list(_PENDING.values())
        else:
            fut = _PENDING.get(os.path.abspath(ckpt_dir))
            futures = [] if fut is None else [fut]
    for fut in futures:
        fut.result()
    barrier()


def _shutdown_writers() -> None:
    with _LOCK:
        writers = list(_WRITERS.values())
        _WRITERS.clear()
    for ex in writers:
        ex.shutdown(wait=True)


atexit.register(_shutdown_writers)


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    extra: dict | None = None,
                    keep_last: int | None = None,
                    async_save: bool = False) -> None:
    """Save a TrainState (or any object with ``state_dict()``, or a nested
    dict of tensors and numbers) plus JSON-able ``extra`` at ``step``."""
    key = os.path.abspath(ckpt_dir)
    wait_for_saves(key)
    latest = latest_step(key)
    if latest is not None and step <= latest:
        log.warning("checkpoint step %d not saved: %s already holds step %d",
                    step, ckpt_dir, latest)
        return
    if world()[0] != 0:
        return
    payload = _host_copy(state)
    if not async_save:
        _write(key, step, payload, extra, keep_last)
        return
    with _LOCK:
        writer = _WRITERS.get(key)
        if writer is None:
            writer = _WRITERS[key] = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-save")
        _PENDING[key] = writer.submit(_write, key, step, payload, extra,
                                      keep_last)


def latest_step(ckpt_dir: str) -> int | None:
    wait_for_saves(ckpt_dir)
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def delete_recent_checkpoints(ckpt_dir: str, n: int) -> list[int]:
    """Delete the n most recent checkpoints (the reference's NaN-loss
    cleanup, so a resume restarts from a state before the divergence)
    -> the deleted steps, newest first."""
    wait_for_saves(ckpt_dir)
    deleted = list(reversed(_steps(ckpt_dir)[-n:] if n > 0 else []))
    barrier()  # every rank has listed the steps before rank 0 deletes
    if world()[0] == 0:
        for step in deleted:
            shutil.rmtree(os.path.join(ckpt_dir, str(step)),
                          ignore_errors=True)
    barrier()
    return deleted


def _resolve(ckpt_dir: str, step: int | None) -> int:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    wait_for_saves(ckpt_dir)
    return step


def restore_raw(ckpt_dir: str, step: int | None = None) -> tuple[Any, int]:
    """(the saved structure as host tensors, step); step None -> latest.
    For partial and cross-model loads (``cli/export.py``)."""
    step = _resolve(ckpt_dir, step)
    path = os.path.join(ckpt_dir, str(step), STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True), step


def restore_checkpoint(ckpt_dir: str, state_template: Any,
                       step: int | None = None) -> tuple[Any, dict | None, int]:
    """(state, extra, step); step None -> latest.  A template with
    ``load_state_dict`` (a TrainState) is restored in place and returned;
    any other template gets the raw saved structure."""
    raw, step = restore_raw(ckpt_dir, step)
    extra_path = os.path.join(ckpt_dir, str(step), EXTRA_FILE)
    extra = None
    if os.path.exists(extra_path):
        with open(extra_path) as f:
            extra = json.load(f)
    if hasattr(state_template, "load_state_dict"):
        state_template.load_state_dict(raw)
        return state_template, extra, step
    return raw, extra, step
