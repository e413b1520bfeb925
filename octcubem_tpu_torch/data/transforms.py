"""Volume / image transforms (host-side numpy, exact torch-kernel resizes;
counterpart of octcubem_tpu/data/transforms.py, draw for draw the same).

Parity target: OCTCube/util/PatientDataset.py:37-65 (create_3d_transforms)
— train: CropForegroundd + trilinear Resized to (num_frames, S, S) +
2 random flips (frames axis, width axis); val: resize only; optional
NormalizeIntensityd(0.25, 0.25, nonzero).  The reference swaps train/val
transforms on one shared dataset object between phases
(main_…singlefold.py:673-678); here transforms are explicit per-split
pipelines instead.  Serving and inference take the val transform,
``create_3d_transforms(...)[1]``: ``Transform3D``'s ``train`` defaults to
True, as in the JAX package, and its train branch crops the foreground
and flips at random.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .np_resize import resize_trilinear_np, resize_bilinear_np


def crop_foreground(vol: np.ndarray) -> np.ndarray:
    """MONAI CropForegroundd default semantics: crop the bounding box of
    voxels > 0 over all three axes. vol: [T, H, W]."""
    nz = vol > 0
    if not nz.any():
        return vol
    out = vol
    for ax in range(3):
        other = tuple(i for i in range(3) if i != ax)
        marg = nz.any(axis=other)
        lo, hi = np.argmax(marg), len(marg) - np.argmax(marg[::-1])
        out = out[(slice(None),) * ax + (slice(lo, hi),)]
        nz = nz[(slice(None),) * ax + (slice(lo, hi),)]
    return out


def normalize_intensity(vol: np.ndarray, subtrahend=0.25, divisor=0.25,
                        nonzero=True) -> np.ndarray:
    if nonzero:
        return np.where(vol != 0, (vol - subtrahend) / divisor, vol)
    return (vol - subtrahend) / divisor


@dataclasses.dataclass
class Transform3D:
    """3D transform matching create_3d_transforms; returns [T, H, W] fp32.
    ``rng`` draws the train branch's flips (a fresh generator if None)."""

    input_size: int = 256
    num_frames: int = 48
    train: bool = True
    flip_prob: float = 0.5
    normalize: bool = False

    def __call__(self, vol: np.ndarray,
                 rng: np.random.Generator | None = None) -> np.ndarray:
        vol = np.asarray(vol, np.float32)
        if self.train:
            vol = crop_foreground(vol)
        vol = resize_trilinear_np(
            vol, (self.num_frames, self.input_size, self.input_size))
        if self.train:
            rng = rng or np.random.default_rng()
            if rng.random() < self.flip_prob:
                vol = vol[::-1]
            if rng.random() < self.flip_prob:
                vol = vol[:, :, ::-1]
        if self.normalize:
            vol = normalize_intensity(vol)
        return np.ascontiguousarray(vol)


def create_3d_transforms(input_size: int, num_frames: int = 64,
                         RandFlipd_prob: float = 0.5,
                         normalize_dataset: bool = False, **_):
    """Reference-signature factory -> (train_transform, val_transform)."""
    train = Transform3D(input_size, num_frames, train=True,
                        flip_prob=RandFlipd_prob, normalize=normalize_dataset)
    val = Transform3D(input_size, num_frames, train=False,
                      normalize=normalize_dataset)
    return train, val


@dataclasses.dataclass
class Transform2D:
    """2D eval-style transform (resize + center crop + normalize), matching
    the eval branch of OCTCube/util/datasets.py:21-54.  Train-time RandAug /
    random-erasing is provided by Transform2DTrain below."""

    input_size: int = 224
    mean: tuple = (0.485, 0.456, 0.406)
    std: tuple = (0.229, 0.224, 0.225)
    crop_pct: float = 0.875

    def __call__(self, img: np.ndarray, rng=None) -> np.ndarray:
        """img: [H, W] or [H, W, C] in [0, 1] -> [S, S, C]."""
        if img.ndim == 2:
            img = img[..., None]
        size = int(self.input_size / self.crop_pct)
        im = resize_bilinear_np(np.moveaxis(img, -1, 0), (size, size))
        top = (size - self.input_size) // 2
        im = im[:, top:top + self.input_size, top:top + self.input_size]
        mean = np.asarray(self.mean[: im.shape[0]], np.float32)[:, None, None]
        std = np.asarray(self.std[: im.shape[0]], np.float32)[:, None, None]
        return np.moveaxis((im - mean) / std, 0, -1)


@dataclasses.dataclass
class Transform2DTrain:
    """Train-time 2D augmentation: random-resized-crop + hflip + normalize.

    The reference uses timm's full RandAug recipe
    (rand-m9-mstd0.5-inc1, util/datasets.py:25-40); this covers the
    geometric core; color-op RandAug can be layered on later.
    """

    input_size: int = 224
    mean: tuple = (0.485, 0.456, 0.406)
    std: tuple = (0.229, 0.224, 0.225)
    scale: tuple = (0.08, 1.0)
    ratio: tuple = (3 / 4, 4 / 3)
    rand_augment: bool = True      # rand-m9-mstd0.5 (datasets.py:25-40)
    random_erase_prob: float = 0.25

    def __call__(self, img: np.ndarray, rng=None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        if img.ndim == 2:
            img = img[..., None]
        h, w = img.shape[:2]
        for _ in range(10):
            area = h * w * rng.uniform(*self.scale)
            ar = np.exp(rng.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            cw = int(round(np.sqrt(area * ar)))
            ch = int(round(np.sqrt(area / ar)))
            if cw <= w and ch <= h:
                top = rng.integers(0, h - ch + 1)
                left = rng.integers(0, w - cw + 1)
                img_c = img[top:top + ch, left:left + cw]
                break
        else:
            s = min(h, w)
            img_c = img[(h - s) // 2:(h + s) // 2, (w - s) // 2:(w + s) // 2]
        im = resize_bilinear_np(np.moveaxis(img_c, -1, 0),
                                (self.input_size, self.input_size))
        if rng.random() < 0.5:
            im = im[:, :, ::-1]
        im_hwc = np.ascontiguousarray(np.moveaxis(im, 0, -1))
        if self.rand_augment:
            from .randaug import rand_augment
            im_hwc = rand_augment(im_hwc, rng)
        mean = np.asarray(self.mean[: im_hwc.shape[-1]], np.float32)
        std = np.asarray(self.std[: im_hwc.shape[-1]], np.float32)
        im_hwc = (im_hwc - mean) / std
        if self.random_erase_prob > 0:
            from .randaug import random_erasing
            im_hwc = random_erasing(im_hwc.astype(np.float32), rng,
                                    self.random_erase_prob)
        return np.ascontiguousarray(im_hwc.astype(np.float32))
