"""Host-side numpy resize with the exact torch-interpolate matrices
(counterpart of octcubem_tpu/data/np_resize.py; the matrices are
ops/resize.py's)."""

from __future__ import annotations

import numpy as np

from ..ops.resize import _interp_matrix_1d


def _linear(in_size: int, out_size: int) -> np.ndarray:
    return _interp_matrix_1d(in_size, out_size, "linear").astype(np.float32)


def resize_trilinear_np(vol: np.ndarray,
                        out_thw: tuple[int, int, int]) -> np.ndarray:
    """[..., T, H, W] linear resize per axis (torch trilinear exact)."""
    t, h, w = vol.shape[-3:]
    ot, oh, ow = out_thw
    vol = vol.astype(np.float32, copy=False)
    if t != ot:
        vol = np.einsum("Tt,...thw->...Thw", _linear(t, ot), vol,
                        optimize=True)
    if h != oh:
        vol = np.einsum("Hh,...thw->...tHw", _linear(h, oh), vol,
                        optimize=True)
    if w != ow:
        vol = np.einsum("Ww,...thw->...thW", _linear(w, ow), vol,
                        optimize=True)
    return vol
