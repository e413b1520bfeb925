"""Host-side numpy resize with the exact torch-interpolate matrices
(counterpart of octcubem_tpu/data/np_resize.py; the matrices are
ops/resize.py's): trilinear volumes, bilinear and bicubic images.
Loader workers never touch the card."""

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


def _resize_hw(img: np.ndarray, out_hw: tuple[int, int],
               mode: str) -> np.ndarray:
    h, w = img.shape[-2:]
    oh, ow = out_hw
    img = img.astype(np.float32, copy=False)
    if h != oh:
        img = np.einsum("Hh,...hw->...Hw",
                        _interp_matrix_1d(h, oh, mode).astype(np.float32),
                        img, optimize=True)
    if w != ow:
        img = np.einsum("Ww,...hw->...hW",
                        _interp_matrix_1d(w, ow, mode).astype(np.float32),
                        img, optimize=True)
    return img


def resize_bilinear_np(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """[..., H, W] bilinear resize (torch mode='bilinear' exact)."""
    return _resize_hw(img, out_hw, "linear")


def resize_bicubic_np(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """[..., H, W] bicubic resize (torch mode='bicubic', A=-0.75 exact)."""
    return _resize_hw(img, out_hw, "cubic")
