"""Device resolution for the port's entry points.

The port is built for the card: with no explicit device it runs on
``cuda`` and refuses to start without one, so a missing card is an
error and never a silent fall back to the CPU.  The CPU is used only
when the caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None -> cuda.  Raises when a CUDA device is asked for (explicitly
    or by default) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host-to-device copy of a numpy batch.  On the card it goes
    through pinned memory with ``non_blocking``, so the host does not wait
    for the work already queued on the stream (a pageable copy would)."""
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
