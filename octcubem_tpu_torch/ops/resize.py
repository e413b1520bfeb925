"""Interpolation as matrix products (counterpart of octcubem_tpu/ops/resize.py).

The reference model pools its high-res learned spatial pos embed down to
the low-res grid inside the forward with
``torch.nn.functional.interpolate(mode='bicubic', align_corners=False)``
(Keys cubic, A = -0.75, border clamp).  As in the JAX package, the port
builds the small (out, in) interpolation matrices once in float64 numpy
and applies them as matrix products, so the result is the JAX package's
to the last rounding, and differentiable.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel, torch's bicubic (A = -0.75)."""
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    return np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=256)
def _interp_matrix_1d(in_size: int, out_size: int, mode: str) -> np.ndarray:
    """(out_size, in_size) row-stochastic interpolation matrix, float64,
    read-only (it is cached and shared).

    torch ``interpolate(align_corners=False, antialias=False)`` exact for
    mode 'cubic' and 'linear', with its border clamp: out-of-range taps
    are accumulated onto the edge samples."""
    if mode not in ("cubic", "linear"):
        raise ValueError(f"unknown mode {mode!r}")
    if in_size == out_size:
        mat = np.eye(in_size, dtype=np.float64)
    else:
        scale = in_size / out_size
        mat = np.zeros((out_size, in_size), dtype=np.float64)
        for i in range(out_size):
            # source coordinate of output sample i (align_corners=False)
            src = (i + 0.5) * scale - 0.5
            base = int(np.floor(src))
            if mode == "cubic":
                taps = np.arange(base - 1, base + 3)
                w = _cubic_kernel(src - taps)
            else:
                taps = np.arange(base, base + 2)
                w = 1.0 - np.abs(src - taps)
            for j, wj in zip(np.clip(taps, 0, in_size - 1), w):
                mat[i, j] += wj
    mat.setflags(write=False)
    return mat


@functools.lru_cache(maxsize=64)
def _device_matrix(in_size: int, out_size: int, mode: str,
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode, so
    # that a later forward under autograd may save it for backward
    with torch.inference_mode(False):
        return torch.tensor(_interp_matrix_1d(in_size, out_size, mode),
                            dtype=dtype, device=device)


def _matrix(in_size: int, out_size: int, mode: str, like: torch.Tensor):
    """The matrix in x's dtype on x's device, copied there once: a copy
    from pageable host memory on every forward would block the host until
    the card had drained its queue."""
    return _device_matrix(in_size, out_size, mode, like.dtype, like.device)


def resize_grid_bicubic(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bicubic-resize the (H, W) grid of x: [..., H, W, D] -> [..., H', W',
    D] (torch bicubic exact)."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    x = torch.einsum("Hh,...hwd->...Hwd", _matrix(h, oh, "cubic", x), x)
    return torch.einsum("Ww,...hwd->...hWd", _matrix(w, ow, "cubic", x), x)


def resize_seq_linear(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Linear-resize along the second-to-last axis: [..., T, D] -> [..., T',
    D] (torch mode='linear' exact; the temporal pos-embed resize)."""
    t = x.shape[-2]
    if t == out_len:
        return x
    return torch.einsum("Tt,...td->...Td", _matrix(t, out_len, "linear", x), x)


def resize_volume_trilinear(x: torch.Tensor,
                            out_thw: tuple[int, int, int]) -> torch.Tensor:
    """Trilinear-resize a volume: [..., T, H, W] -> [..., T', H', W']
    (torch ``interpolate(mode='trilinear', align_corners=False)``, the
    reference's val-transform resize), as three matrix products along T,
    then H, then W."""
    t, h, w = x.shape[-3], x.shape[-2], x.shape[-1]
    ot, oh, ow = out_thw
    if (t, h, w) == (ot, oh, ow):
        return x
    x = torch.einsum("Tt,...thw->...Thw", _matrix(t, ot, "linear", x), x)
    x = torch.einsum("Hh,...thw->...tHw", _matrix(h, oh, "linear", x), x)
    return torch.einsum("Ww,...thw->...thW", _matrix(w, ow, "linear", x), x)
