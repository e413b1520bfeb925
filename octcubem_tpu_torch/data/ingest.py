"""Volume ingestion: PNG frame stacks, npy volumes, DICOM — with the
reference's exact normalization behaviours (counterpart of
octcubem_tpu/data/ingest.py; plain numpy, so its results are bit-equal
to the JAX package's).

Parity targets (OCTCube/util/PatientDataset.py):
- frame mode (:524-588): PIL stack, width/height 1024 -> 512 downsample,
  center-crop / zero-pad to max_frames (or 3x-replicated center frame).
- volume mode (:589-651): npy, /255, 2x box downsample, bicubic
  volume_resize.
- dicom_aireadi mode (:652-807): per-manufacturer normalization tables
  (Heidelberg pass-through; Topcon Maestro2/Triton mean/std shifting),
  Otsu-threshold column-crop detection with pixel clipping, bilinear
  height-resize to 496, min-max normalize.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .np_resize import resize_bilinear_np, resize_bicubic_np

# per-device normalization table (PatientDataset.py:666-682)
DEVICE_NORMALIZATION = {
    ("Heidelberg", None): dict(shift_mean=0.0, shift_std=1.0,
                               origin_mean=0.0, origin_std=1.0),
    ("Topcon", "Maestro2"): dict(shift_mean=0.15, shift_std=0.18,
                                 origin_mean=0.15, origin_std=0.14),
    ("Topcon", "Triton"): dict(shift_mean=0.15, shift_std=0.21,
                               origin_mean=0.16, origin_std=0.15),
}


def load_frame_stack(paths: list[str], mode: str = "gray",
                     downsample_width: bool = True) -> np.ndarray:
    """Load ordered PNG frames -> [T, H, W] (gray) or [T, H, W, 3] float in
    [0, 1].  Grayscale stacks go through the native threaded C++ decoder
    when available (octcubem_tpu_torch/native), falling back to PIL."""
    if mode == "gray" and paths and paths[0].endswith(".png"):
        from .. import native

        vol = native.load_png_stack_native(paths, downsample_width)
        if vol is not None:
            return vol
    from PIL import Image

    frames = []
    for p in paths:
        img = Image.open(p)
        img = img.convert("RGB" if mode == "rgb" else "L")
        if downsample_width:
            if img.size[0] == 1024:
                img = img.resize((512, img.size[1]))
            if img.size[1] == 1024:
                img = img.resize((img.size[0], 512))
        frames.append(np.asarray(img, np.float32) / 255.0)
    return np.stack(frames)


def pad_or_crop_paths(paths: list[str], max_frames: int) -> list[str]:
    """Mirror pad_or_crop_frames on the frame-path list: center-crop, or
    symmetric-pad with '' placeholders for the zero frames."""
    t = len(paths)
    if t > max_frames:
        start = t // 2 - max_frames // 2
        return list(paths[start:start + max_frames])
    if t < max_frames:
        pad = max_frames - t
        left = pad // 2
        return [""] * left + list(paths) + [""] * (pad - left)
    return list(paths)


def pad_or_crop_frames(vol: np.ndarray, max_frames: int,
                       same_3_frames: bool = False) -> np.ndarray:
    """Center-crop or symmetric zero-pad the frame axis to max_frames
    (PatientDataset.py:552-575)."""
    t = vol.shape[0]
    if t > max_frames:
        if same_3_frames:
            assert max_frames == 3
            c = (t - 1) // 2
            return np.repeat(vol[c:c + 1], 3, axis=0)
        start = t // 2 - max_frames // 2
        return vol[start:start + max_frames]
    if t < max_frames:
        pad = max_frames - t
        left, right = pad // 2, pad - pad // 2
        z = np.zeros((left,) + vol.shape[1:], vol.dtype)
        z2 = np.zeros((right,) + vol.shape[1:], vol.dtype)
        return np.concatenate([z, vol, z2], axis=0)
    return vol


def load_npy_volume(path: str, downsample_width: bool = True,
                    volume_resize: tuple[int, int] | None = None) -> np.ndarray:
    """npy [D, H, W] -> float volume with the reference's /255 + 2x box
    downsample + bicubic resize (PatientDataset.py:589-651).  Note the
    reference pads short volumes with a buggy no-op (SURVEY §7.3 'volume
    padding bug'); we use the corrected symmetric pad via
    pad_or_crop_frames at the dataset level."""
    vol = np.load(path).astype(np.float32) / 255.0
    if downsample_width:
        if vol.shape[-2] == 1024:
            vol = (vol[..., ::2, :] + vol[..., 1::2, :]) / 2
        if vol.shape[-1] == 1024:
            vol = (vol[..., :, ::2] + vol[..., :, 1::2]) / 2
    if volume_resize is not None:
        vol = resize_bicubic_np(vol, volume_resize)
    return vol


def otsu_threshold(img: np.ndarray, nbins: int = 256) -> float:
    """Otsu's method (replaces skimage.filters.threshold_otsu)."""
    hist, edges = np.histogram(img.ravel(), bins=nbins)
    centers = (edges[:-1] + edges[1:]) / 2
    hist = hist.astype(np.float64)
    w0 = np.cumsum(hist)                      # class-0 weight up to bin i
    w1 = w0[-1] - w0                          # class-1 weight above bin i
    csum = np.cumsum(hist * centers)
    m0 = csum / np.maximum(w0, 1e-12)
    m1 = (csum[-1] - csum) / np.maximum(w1, 1e-12)
    var = w0 * w1 * (m0 - m1) ** 2            # between-class variance
    return float(centers[np.argmax(var)])


@dataclasses.dataclass
class TopconCropInfo:
    crop_start_col: int
    crop_end_col: int
    min_pixel_val: float
    max_pixel_value: float


def topcon_detect_crop(volume: np.ndarray, model_name: str) -> TopconCropInfo:
    """Otsu-based retina-band column detection for Topcon volumes
    (PatientDataset.py:702-750)."""
    max_pixel_value = 200.0
    mean_vol = volume.mean(axis=0)
    val = otsu_threshold(mean_vol)
    min_pixel_val = max(float(np.ceil(mean_vol.min())) - 5, 0.0)
    foreground = (mean_vol > val - 10).astype(np.int64)

    start_col = 100
    end_col = 700 if model_name == "Maestro2" else 750
    default_gap = end_col - start_col
    not_all_zero = np.any(foreground == 1, axis=1)
    idx = np.where(not_all_zero)[0]
    if len(idx) == 0:
        return TopconCropInfo(start_col, end_col, min_pixel_val, max_pixel_value)
    first, last = int(idx[0]), int(idx[-1])
    gap = last - first + 1
    if gap < default_gap - 200:
        cs = start_col if first >= start_col + 100 else max(0, first - 100)
        if cs < start_col:
            ce = cs + default_gap
        else:
            ce = end_col if last <= end_col - 100 else min(volume.shape[1], last + 100)
            if ce > end_col:
                cs = ce - default_gap
    else:
        cs = max(0, first - 100)
        ce = min(volume.shape[1], last + 100)
    return TopconCropInfo(cs, ce, min_pixel_val, max_pixel_value)


def normalize_dicom_volume(volume: np.ndarray, manufacturer: str,
                           model_name: str, shift_mean_std: bool = True,
                           crop_info: TopconCropInfo | None = None,
                           downsample_width: bool = True) -> np.ndarray:
    """Full dicom_aireadi normalization chain (PatientDataset.py:652-766)."""
    volume = volume.astype(np.float32)
    key = ("Topcon", model_name) if manufacturer == "Topcon" else ("Heidelberg", None)
    table = DEVICE_NORMALIZATION.get(key, DEVICE_NORMALIZATION[("Heidelberg", None)])

    if manufacturer == "Topcon":
        if crop_info is None:
            crop_info = topcon_detect_crop(volume, model_name)
        volume = volume[:, crop_info.crop_start_col:crop_info.crop_end_col, :]
        lo = crop_info.min_pixel_val
        volume = np.clip(volume, lo, crop_info.max_pixel_value)

    if model_name != "Heidelberg" and manufacturer != "Heidelberg":
        volume = resize_bilinear_np(volume, (496, volume.shape[2]))

    rng_ = volume.max() - volume.min()
    volume = (volume - volume.min()) / (rng_ if rng_ > 0 else 1.0)
    if shift_mean_std:
        volume = volume / table["origin_std"] * table["shift_std"]

    if downsample_width:
        if volume.shape[-2] == 1024:
            volume = (volume[..., ::2, :] + volume[..., 1::2, :]) / 2
        if volume.shape[-1] == 1024:
            volume = (volume[..., :, ::2] + volume[..., :, 1::2]) / 2
    return volume


def load_mhd_volume(path: str) -> np.ndarray:
    """MetaImage (.mhd/.mha) volume reader — replaces the COEM fork's
    SimpleITK-backed load_mhd_image (retinal-COEM/src/training/
    multimodal_dataset.py:483-496).  Supports uncompressed and
    zlib-compressed raw payloads, common element types."""
    import zlib

    hdr: dict[str, str] = {}
    with open(path, "rb") as f:
        data = f.read()
    # header is ASCII lines until ElementDataFile
    text_end = 0
    for line in data.split(b"\n"):
        text_end += len(line) + 1
        try:
            k, v = line.decode("ascii").split("=", 1)
        except (UnicodeDecodeError, ValueError):
            break
        hdr[k.strip()] = v.strip()
        if k.strip() == "ElementDataFile":
            break
    dims = [int(x) for x in hdr["DimSize"].split()]
    dtype = {
        "MET_UCHAR": np.uint8, "MET_CHAR": np.int8,
        "MET_USHORT": np.uint16, "MET_SHORT": np.int16,
        "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
    }[hdr.get("ElementType", "MET_UCHAR")]
    datafile = hdr.get("ElementDataFile", "LOCAL")
    if datafile == "LOCAL":
        raw = data[text_end:]
    else:
        with open(os.path.join(os.path.dirname(path), datafile), "rb") as f:
            raw = f.read()
    if hdr.get("CompressedData", "False").lower() == "true":
        raw = zlib.decompress(raw)
    n = int(np.prod(dims))
    arr = np.frombuffer(raw, dtype=dtype, count=n)
    # MetaImage DimSize is x y z (fastest first) -> numpy [z, y, x]
    return arr.reshape(dims[::-1]).astype(np.float32)


def load_dicom_volume(path: str, **kw) -> tuple[np.ndarray, str, str]:
    """Read + normalize a DICOM OCT volume. Returns (vol, manufacturer,
    model_name)."""
    from .dicom import read_dicom

    d = read_dicom(path)
    vol = d.pixel_array.astype(np.float32)
    if vol.ndim == 2:
        vol = vol[None]
    return (normalize_dicom_volume(vol, d.manufacturer, d.model_name, **kw),
            d.manufacturer, d.model_name)
