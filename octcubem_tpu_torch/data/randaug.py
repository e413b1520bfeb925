"""RandAugment for the 2D fine-tune pipeline (numpy, host-side;
counterpart of octcubem_tpu/data/randaug.py, draw for draw the same).

Parity target: the timm recipe the reference requests via
create_transform('rand-m9-mstd0.5-inc1', ...) (OCTCube/util/
datasets.py:25-40) and the inherited rand_augment.py.  Implements the
standard RandAugment op set with magnitude 9, std-0.5 magnitude jitter,
and the 'inc1' increasing-severity mappings.  Operates on float images in
[0, 1], any channel count.
"""

from __future__ import annotations

import numpy as np

_MAX_MAG = 10.0


def _blend(a, b, f):
    return np.clip(a * (1 - f) + b * f, 0.0, 1.0)


def _affine(img, mat, fill=0.5):
    """Inverse-warp with bilinear sampling; mat maps output -> input."""
    h, w = img.shape[:2]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = np.stack([xx - w / 2, yy - h / 2, np.ones_like(xx)], axis=-1)
    src = coords @ mat.T
    sx = src[..., 0] + w / 2
    sy = src[..., 1] + h / 2
    x0c = np.clip(np.floor(sx).astype(int), 0, w - 2)
    y0c = np.clip(np.floor(sy).astype(int), 0, h - 2)
    fx = (sx - x0c)[..., None]
    fy = (sy - y0c)[..., None]
    out = np.zeros_like(img) + fill
    valid = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    interp = (img[y0c, x0c] * (1 - fx) * (1 - fy)
              + img[y0c, x0c + 1] * fx * (1 - fy)
              + img[y0c + 1, x0c] * (1 - fx) * fy
              + img[y0c + 1, x0c + 1] * fx * fy)
    out = np.where(valid[..., None], interp, out)
    return out.astype(np.float32)


def _level(mag, max_val, increasing=True):
    return mag / _MAX_MAG * max_val


# each op: (fn(img, magnitude, rng), signed?)

def op_identity(img, m, rng):
    return img


def op_autocontrast(img, m, rng):
    lo = img.min(axis=(0, 1), keepdims=True)
    hi = img.max(axis=(0, 1), keepdims=True)
    scale = np.where(hi > lo, 1.0 / np.maximum(hi - lo, 1e-6), 1.0)
    return np.clip((img - lo) * scale, 0, 1).astype(np.float32)


def op_equalize(img, m, rng):
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        v = (img[..., c] * 255).astype(np.uint8)
        hist = np.bincount(v.ravel(), minlength=256)
        cdf = hist.cumsum()
        nz = cdf[cdf > 0]
        if len(nz) == 0:
            out[..., c] = img[..., c]
            continue
        lut = np.clip((cdf - nz[0]) * 255.0 / max(cdf[-1] - nz[0], 1), 0, 255)
        out[..., c] = lut[v] / 255.0
    return out.astype(np.float32)


def op_invert(img, m, rng):
    return (1.0 - img).astype(np.float32)


def op_posterize(img, m, rng):
    bits = max(1, 8 - int(round(_level(m, 4))))
    q = (img * 255).astype(np.uint8) >> (8 - bits) << (8 - bits)
    return (q / 255.0).astype(np.float32)


def op_solarize(img, m, rng):
    thr = 1.0 - _level(m, 1.0)
    return np.where(img >= thr, 1.0 - img, img).astype(np.float32)


def op_contrast(img, m, rng, sign=1):
    f = 1.0 + sign * _level(m, 0.9)
    mean = img.mean()
    return _blend(np.full_like(img, mean), img, f).astype(np.float32)


def op_brightness(img, m, rng, sign=1):
    f = 1.0 + sign * _level(m, 0.9)
    return _blend(np.zeros_like(img), img, f).astype(np.float32)


def op_color(img, m, rng, sign=1):
    f = 1.0 + sign * _level(m, 0.9)
    gray = img.mean(axis=-1, keepdims=True)
    return _blend(np.broadcast_to(gray, img.shape), img, f).astype(np.float32)


def op_sharpness(img, m, rng, sign=1):
    f = 1.0 + sign * _level(m, 0.9)
    k = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0
    blurred = np.stack([
        np.pad(_conv2(img[..., c], k), 0) for c in range(img.shape[-1])
    ], axis=-1)
    return _blend(blurred, img, f).astype(np.float32)


def _conv2(x, k):
    h, w = x.shape
    xp = np.pad(x, 1, mode="edge")
    out = np.zeros_like(x)
    for i in range(3):
        for j in range(3):
            out += k[i, j] * xp[i:i + h, j:j + w]
    return out


def op_rotate(img, m, rng, sign=1):
    deg = sign * _level(m, 30.0)
    t = np.deg2rad(deg)
    mat = np.array([[np.cos(t), -np.sin(t), 0],
                    [np.sin(t), np.cos(t), 0]], np.float32)
    return _affine(img, mat)


def op_shear_x(img, m, rng, sign=1):
    s = sign * _level(m, 0.3)
    return _affine(img, np.array([[1, s, 0], [0, 1, 0]], np.float32))


def op_shear_y(img, m, rng, sign=1):
    s = sign * _level(m, 0.3)
    return _affine(img, np.array([[1, 0, 0], [s, 1, 0]], np.float32))


def op_translate_x(img, m, rng, sign=1):
    t = sign * _level(m, 0.45) * img.shape[1]
    return _affine(img, np.array([[1, 0, t], [0, 1, 0]], np.float32))


def op_translate_y(img, m, rng, sign=1):
    t = sign * _level(m, 0.45) * img.shape[0]
    return _affine(img, np.array([[1, 0, 0], [0, 1, t]], np.float32))


_SIGNED = {op_contrast, op_brightness, op_color, op_sharpness, op_rotate,
           op_shear_x, op_shear_y, op_translate_x, op_translate_y}
_OPS = [op_identity, op_autocontrast, op_equalize, op_invert, op_posterize,
        op_solarize, op_contrast, op_brightness, op_color, op_sharpness,
        op_rotate, op_shear_x, op_shear_y, op_translate_x, op_translate_y]


def rand_augment(img: np.ndarray, rng: np.random.Generator,
                 num_ops: int = 2, magnitude: float = 9.0,
                 mag_std: float = 0.5) -> np.ndarray:
    """Apply `num_ops` random ops at magnitude ~ N(magnitude, mag_std),
    the 'rand-m9-mstd0.5' configuration."""
    for _ in range(num_ops):
        op = _OPS[rng.integers(len(_OPS))]
        m = float(np.clip(rng.normal(magnitude, mag_std), 0, _MAX_MAG))
        if op in _SIGNED:
            img = op(img, m, rng, sign=1 if rng.random() < 0.5 else -1)
        else:
            img = op(img, m, rng)
    return img


def mixup_cutmix(images: np.ndarray, targets_onehot: np.ndarray,
                 rng: np.random.Generator, mixup_alpha: float = 0.8,
                 cutmix_alpha: float = 1.0, prob: float = 1.0,
                 switch_prob: float = 0.5):
    """Batch-level mixup/cutmix (the timm mixup_fn the reference's 2D
    fine-tune path requests, engine_finetune.py mixup_fn).  images
    [B, H, W, C], targets one-hot [B, C] -> mixed (images, soft targets)."""
    if rng.random() > prob:
        return images, targets_onehot
    b = images.shape[0]
    perm = rng.permutation(b)
    use_cutmix = rng.random() < switch_prob
    if use_cutmix:
        lam = float(rng.beta(cutmix_alpha, cutmix_alpha))
        h, w = images.shape[1:3]
        rh, rw = int(h * np.sqrt(1 - lam)), int(w * np.sqrt(1 - lam))
        cy, cx = rng.integers(h), rng.integers(w)
        y0, y1 = np.clip(cy - rh // 2, 0, h), np.clip(cy + rh // 2, 0, h)
        x0, x1 = np.clip(cx - rw // 2, 0, w), np.clip(cx + rw // 2, 0, w)
        out = images.copy()
        out[:, y0:y1, x0:x1] = images[perm][:, y0:y1, x0:x1]
        lam = 1 - (y1 - y0) * (x1 - x0) / (h * w)
    else:
        lam = float(rng.beta(mixup_alpha, mixup_alpha))
        out = lam * images + (1 - lam) * images[perm]
    t = lam * targets_onehot + (1 - lam) * targets_onehot[perm]
    return out.astype(np.float32), t.astype(np.float32)


def random_erasing(img: np.ndarray, rng: np.random.Generator,
                   prob: float = 0.25, area=(0.02, 1 / 3),
                   ratio=(0.3, 3.3)) -> np.ndarray:
    """timm-style random erasing with gaussian fill
    (util/random_erasing.py)."""
    if rng.random() > prob:
        return img
    h, w = img.shape[:2]
    for _ in range(10):
        a = rng.uniform(*area) * h * w
        r = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        eh = int(round(np.sqrt(a * r)))
        ew = int(round(np.sqrt(a / r)))
        if eh < h and ew < w and eh > 0 and ew > 0:
            top = rng.integers(0, h - eh)
            left = rng.integers(0, w - ew)
            img = img.copy()
            img[top:top + eh, left:left + ew] = rng.standard_normal(
                (eh, ew, img.shape[-1])).astype(np.float32) * 0.2 + 0.5
            return img
    return img
