"""Host-side numpy resize with the exact torch-interpolate matrices
(counterpart of octcubem_tpu/data/np_resize.py; the matrix builder is the
port's own copy of octcubem_tpu/ops/resize.py::_interp_matrix_1d)."""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=256)
def _interp_matrix_1d(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) row-stochastic linear interpolation matrix,
    torch ``interpolate(mode='linear', align_corners=False)`` exact,
    border taps accumulated onto the edge samples."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float64)
    scale = in_size / out_size
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        base = int(np.floor(src))
        taps = np.arange(base, base + 2)
        w = 1.0 - np.abs(src - taps)
        for j, wj in zip(np.clip(taps, 0, in_size - 1), w):
            mat[i, j] += wj
    return mat


def resize_trilinear_np(vol: np.ndarray,
                        out_thw: tuple[int, int, int]) -> np.ndarray:
    """[..., T, H, W] linear resize per axis (torch trilinear exact)."""
    t, h, w = vol.shape[-3:]
    ot, oh, ow = out_thw
    vol = vol.astype(np.float32, copy=False)
    if t != ot:
        vol = np.einsum("Tt,...thw->...Thw",
                        _interp_matrix_1d(t, ot).astype(np.float32), vol,
                        optimize=True)
    if h != oh:
        vol = np.einsum("Hh,...thw->...tHw",
                        _interp_matrix_1d(h, oh).astype(np.float32), vol,
                        optimize=True)
    if w != ow:
        vol = np.einsum("Ww,...thw->...thW",
                        _interp_matrix_1d(w, ow).astype(np.float32), vol,
                        optimize=True)
    return vol
