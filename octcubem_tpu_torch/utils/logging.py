"""Observability: windowed meters, epoch logging, TensorBoard, timing.

Parity targets (SURVEY §2.10/§5.5): MetricLogger / SmoothedValue
(OCTCube/util/misc.py:33-177), timestamped master printing (:179-193),
log.txt JSON-lines per epoch (main_pretrain…py:654-667), TensorBoard
scalars on the epoch_1000x pseudo-step (engine_finetune.py:471-477),
samples/s meters (train_retclip.py:210-227).

Counterpart of octcubem_tpu/utils/logging.py: "master-only" gating keys
off the ``torch.distributed`` rank (rank 0, or the one process when no
group is initialized).
"""

from __future__ import annotations

import collections
import datetime
import json
import logging
import os
import time
from typing import Iterable


def is_master() -> bool:
    from ..core.multihost import world

    return world()[0] == 0


def get_logger(name: str = "octcubem", log_file: str | None = None,
               level=logging.INFO) -> logging.Logger:
    """Named logger with console + optional file output.

    Python loggers are process-global singletons, so a second main() in
    the same process (CLI called as a library, back-to-back test runs)
    gets the SAME logger object — if it asks for a different log_file,
    the file handler is retargeted to the new path instead of silently
    appending to the previous run's out.log.  Calls without log_file
    never strip an existing file handler.
    """
    logger = logging.getLogger(name)
    fmt = logging.Formatter("[%(asctime)s] %(levelname)s %(message)s",
                            "%Y-%m-%d %H:%M:%S")
    if not logger.handlers:
        logger.setLevel(level)
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file and is_master():
        path = os.path.abspath(log_file)
        file_handlers = [h for h in logger.handlers
                         if isinstance(h, logging.FileHandler)]
        if not any(h.baseFilename == path for h in file_handlers):
            for h in file_handlers:
                logger.removeHandler(h)
                h.close()
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class SmoothedValue:
    """Windowed + global average meter (misc.py:33-100)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{k}: {v}" for k, v in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "",
                  total: int | None = None, logger=None):
        """Iterate with iter-time / data-time / ETA logging
        (misc.py:132-177)."""
        log = (logger.info if logger else print) if is_master() else (lambda *a: None)
        i = 0
        if total is None:
            total = len(iterable) if hasattr(iterable, "__len__") else None
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    log(f"{header} [{i}/{total}] eta: {eta_str} {self} "
                        f"time: {iter_time} data: {data_time}")
                else:
                    log(f"{header} [{i}] {self} time: {iter_time} data: {data_time}")
            i += 1
            end = time.time()
        dt = time.time() - start
        log(f"{header} Total time: {datetime.timedelta(seconds=int(dt))} "
            f"({dt / max(i, 1):.4f} s / it)")


class JsonlLogger:
    """log.txt JSON-lines per epoch (main_pretrain…py:654-667)."""

    def __init__(self, out_dir: str, filename: str = "log.txt"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)

    def write(self, record: dict):
        if not is_master():
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")


class TBWriter:
    """TensorBoard writer with the reference's epoch_1000x pseudo-step."""

    def __init__(self, log_dir: str):
        self.writer = None
        if is_master():
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.writer = SummaryWriter(log_dir=log_dir)
            except Exception:
                self.writer = None

    def scalar(self, tag: str, value, epoch_frac: float):
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), int(epoch_frac * 1000))

    def flush(self):
        if self.writer is not None:
            self.writer.flush()


class WandbWriter:
    """Import-guarded Weights & Biases adapter (main_retclip.py:288-308).

    Where the wandb package is absent, construction degrades to a no-op
    (`active` False) with a warning and TB + JSONL remain the logging
    substrate; where wandb IS installed, `enabled=True` mirrors the
    reference's init (project/name/dir/config) and per-step `wandb.log`.
    """

    def __init__(self, enabled: bool, out_dir: str, project: str = "octcubem",
                 name: str = "run", config: dict | None = None,
                 notes: str = ""):
        self.run = None
        if not (enabled and is_master()):
            return
        try:
            import wandb
        except ImportError:
            get_logger().warning(
                "wandb requested but not installed; falling back to "
                "TensorBoard + JSONL logging")
            return
        wandb_dir = os.path.join(out_dir, "wandb")
        os.makedirs(wandb_dir, exist_ok=True)
        self.run = wandb.init(project=project, dir=wandb_dir, name=name,
                              notes=notes, tags=[], config=config or {})
        self._log = wandb.log

    @property
    def active(self) -> bool:
        return self.run is not None

    def log(self, record: dict, step: int | None = None):
        if self.run is not None:
            self._log({k: v for k, v in record.items()
                       if isinstance(v, (int, float))}, step=step)

    def finish(self):
        if self.run is not None:
            self.run.finish()
            self.run = None


def device_memory_stats() -> dict:
    """Per-device memory telemetry from ``torch.cuda.memory_stats()`` —
    replaces the reference's gpu_mem_usage/cpu_mem_usage meters
    (custom_util/misc.py:633-657).  Bytes held by tensors now and at the
    peak since the last ``torch.cuda.reset_peak_memory_stats()``."""
    import torch

    out = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if stats:
                out[f"cuda:{i}"] = {
                    "bytes_in_use_MB": round(stats.get(
                        "allocated_bytes.all.current", 0) / 1e6, 1),
                    "peak_bytes_MB": round(stats.get(
                        "allocated_bytes.all.peak", 0) / 1e6, 1),
                }
    try:
        import psutil

        out["host_rss_MB"] = round(
            psutil.Process().memory_info().rss / 1e6, 1)
    except Exception:
        pass
    return out


class Throughput:
    """samples/s meter (train_retclip.py:210-227)."""

    def __init__(self):
        self.t0 = time.time()
        self.samples = 0

    def update(self, n: int):
        self.samples += n

    @property
    def rate(self) -> float:
        return self.samples / max(time.time() - self.t0, 1e-9)
