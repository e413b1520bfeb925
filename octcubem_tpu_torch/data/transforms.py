"""Validation volume transform (counterpart of the val branch of
octcubem_tpu/data/transforms.py::create_3d_transforms): trilinear resize
to (num_frames, S, S), optional NormalizeIntensityd(0.25, 0.25,
nonzero).  The train-time crop and flips come with the training path."""

from __future__ import annotations

import dataclasses

import numpy as np

from .np_resize import resize_trilinear_np


def normalize_intensity(vol: np.ndarray, subtrahend=0.25, divisor=0.25,
                        nonzero=True) -> np.ndarray:
    if nonzero:
        return np.where(vol != 0, (vol - subtrahend) / divisor, vol)
    return (vol - subtrahend) / divisor


@dataclasses.dataclass
class Transform3D:
    """[T, H, W] -> [num_frames, input_size, input_size] fp32."""

    input_size: int = 256
    num_frames: int = 48
    normalize: bool = False

    def __call__(self, vol: np.ndarray) -> np.ndarray:
        vol = resize_trilinear_np(
            np.asarray(vol, np.float32),
            (self.num_frames, self.input_size, self.input_size))
        if self.normalize:
            vol = normalize_intensity(vol)
        return np.ascontiguousarray(vol)
