"""Rendering of MAE reconstructions, confusion matrices and Grad-CAM
overlays (counterpart of octcubem_tpu/utils/visualization.py; the port's
own copy).

matplotlib is imported inside each renderer, never at import: a machine
without it (the card's) imports this module, and only a call to a
renderer needs it.  The confusion matrix, which ``cli/finetune.py``
writes after each new best epoch, has a second renderer for such a
machine: ``write_matrix_png``, a shaded grid (one cell per entry, darker
for larger counts) encoded with zlib and struct alone.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from ..ops.patchify import unpatchify_3d


def reconstruction_panels(imgs: np.ndarray, pred_tokens: np.ndarray,
                          mask: np.ndarray, t_patch: int, patch: int,
                          grid: tuple[int, int, int]):
    """Build (original, masked-input, reconstruction, paste) volumes.

    imgs: [B, T, H, W, C]; pred_tokens: [B, L, u*p*p*C]; mask: [B, L]
    (1 = masked).  Returns four [B, T, H, W, C] arrays.
    """
    b, l = mask.shape
    c = imgs.shape[-1]
    recon = unpatchify_3d(torch.as_tensor(np.asarray(pred_tokens)), t_patch,
                          patch, grid, c).numpy()
    # expand token mask to pixels: kron of [B, g0, g1, g2] with a
    # [t_patch, patch, patch] block of ones yields the interleaved
    # [B, g0*t_patch, g1*patch, g2*patch] = [B, T, H, W] pixel mask
    # directly (each token's value tiled over its tube)
    mask_px = np.kron(mask.reshape(b, *grid).astype(np.float64),
                      np.ones((t_patch, patch, patch)))[..., None]
    imgs = np.asarray(imgs)
    masked_input = imgs * (1 - mask_px)
    pasted = imgs * (1 - mask_px) + recon * mask_px
    return imgs, masked_input, recon, pasted


def write_matrix_png(cm: np.ndarray, out_path: str, cell: int = 24) -> str:
    """A count matrix as an 8-bit gray PNG: one ``cell``-pixel square per
    entry, white for 0 to black for the largest count, 1-pixel grid
    lines; written with zlib and struct (no imaging library)."""
    cm = np.asarray(cm)
    rows, cols = cm.shape
    top = max(int(cm.max()), 1)
    shade = (255 - np.round(224 * cm / top)).astype(np.uint8)
    img = np.kron(shade, np.ones((cell, cell), np.uint8))
    img[::cell, :] = 128
    img[:, ::cell] = 128
    img = np.pad(img, ((0, 1), (0, 1)), constant_values=128)
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
    return out_path


def save_confusion_matrix(y_true, y_pred, class_names, out_path: str):
    """Confusion-matrix image, the matplotlib equivalent of the
    reference's pycm JPEG dumps (engine_finetune.py:766-776); without
    matplotlib, ``write_matrix_png``'s shaded grid.  Returns the counts
    [true, predicted]."""
    n = len(class_names)
    cm = np.zeros((n, n), np.int64)
    for t, p in zip(np.asarray(y_true), np.asarray(y_pred)):
        cm[int(t), int(p)] += 1
    try:
        import matplotlib
    except ImportError:
        write_matrix_png(cm, out_path)
        return cm
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(1 + 0.6 * n, 1 + 0.6 * n))
    ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(n), class_names, rotation=45, ha="right", fontsize=7)
    ax.set_yticks(range(n), class_names, fontsize=7)
    for i in range(n):
        for j in range(n):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center", fontsize=7)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return cm


def save_recon_grid(panels, out_dir: str, tag: str, frame_stride: int = 10):
    """Save a PNG grid: rows = (orig, masked, recon, pasted), cols =
    sampled frames (matplotlib)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    orig, masked, recon, pasted = [p[0, ..., 0] for p in panels]
    frames = list(range(0, orig.shape[0], frame_stride)) or [0]
    fig, axes = plt.subplots(4, len(frames),
                             figsize=(2 * len(frames), 8), squeeze=False)
    for col, fidx in enumerate(frames):
        for row, (vol, name) in enumerate(
                [(orig, "original"), (masked, "masked"),
                 (recon, "recon"), (pasted, "recon+visible")]):
            ax = axes[row][col]
            ax.imshow(vol[fidx], cmap="gray")
            ax.axis("off")
            if col == 0:
                ax.set_title(name, fontsize=8, loc="left")
    path = os.path.join(out_dir, f"recon_{tag}.png")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def save_cam_overlays(volume: np.ndarray, cam: np.ndarray, out_dir: str,
                      tag: str = "cam", frame_stride: int = 8,
                      alpha: float = 0.5) -> str:
    """Render Grad-CAM heatmap overlays onto volume frames.

    The reference's pytorch-grad-cam rendering (scale_cam_image and a
    colormap blended onto the input image).

    volume: [T, H, W] grayscale in [0, 1] (or [0, 255]).
    cam:    [t_grid, h, w] token saliency in [0, 1] (utils.saliency.gradcam
            output for one sample).  Each t-slice covers a t_patch-sized
            tube of frames; spatial maps are bilinearly upsampled.

    Writes a PNG grid (rows = frame, heatmap overlay) and returns its path.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    vol = np.asarray(volume, np.float32)
    if vol.max() > 1.5:
        vol = vol / 255.0
    T, H, W = vol.shape
    cam = np.asarray(cam, np.float32)
    t_grid = cam.shape[0]
    frames = list(range(0, T, frame_stride)) or [0]
    fig, axes = plt.subplots(2, len(frames),
                             figsize=(2 * len(frames), 4.2), squeeze=False)
    for col, fidx in enumerate(frames):
        # frame -> covering tube (t-slice of the token grid)
        tslice = min(int(fidx * t_grid / max(T, 1)), t_grid - 1)
        axes[0][col].imshow(vol[fidx], cmap="gray", vmin=0, vmax=1)
        axes[0][col].axis("off")
        axes[0][col].set_title(f"frame {fidx}", fontsize=7)
        axes[1][col].imshow(vol[fidx], cmap="gray", vmin=0, vmax=1)
        # imshow interpolates the coarse token map over the frame extent
        axes[1][col].imshow(cam[tslice], cmap="jet", alpha=alpha,
                            vmin=0.0, vmax=1.0, extent=(0, W, H, 0),
                            interpolation="bilinear")
        axes[1][col].axis("off")
    path = os.path.join(out_dir, f"{tag}.png")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
