"""B-scan position -> en face patch coverage geometry (the port's copy of
octcubem_tpu/data/geometry.py, pure numpy).

Parity target: retinal-COEM/src/training/multimodal_dataset.py:42-280 —
map each OCT B-scan's line segment on the en face (IR) image to the set
of covered ViT patches, so OCT-token saliency can be projected onto the
IR patch grid, and derive the OCT token sub-grid actually covered by a
device's scan protocol (get_oct_patch_idx_based_on_oct_res).

The reference walks each scan line with per-patch Python conditionals;
here the same coverage rule (a patch counts as covered when at least
`coverage` of its extent lies under the scan line, including the
reference's up/down y-rounding) is computed vectorized over all frames.
"""

from __future__ import annotations

import numpy as np


def horizontal_line_patches(start_x: float, end_x: float, y: float,
                            patch_size: int = 16, coverage: float = 0.5,
                            y_direction: str = "up",
                            grid_limit: int = 384) -> list[tuple[int, int]]:
    """Patches covered by one horizontal scan line (reference
    get_horizontal_patches semantics, :93-140)."""
    thr = round(patch_size * coverage)
    start_px = int((start_x + patch_size - thr) // patch_size)
    end_px = int((end_x + thr) // patch_size)
    if y_direction == "down":
        cand = int(y // patch_size) - 1
        py = cand if y < (cand + 2) * patch_size - thr else cand + 1
    else:
        cand = int(y // patch_size)
        py = cand + 1 if y >= cand * patch_size + thr else cand
    n = grid_limit // patch_size
    start_px = min(max(start_px, 0), n)
    end_px = min(max(end_px, 0), n)
    py = min(max(py, 0), n - 1)
    return [(x, py) for x in range(start_px, end_px)]


def bscan_coverage_mask(scan_lines: np.ndarray, enface_size: int = 384,
                        patch_size: int = 16, coverage: float = 0.5,
                        flip_y: bool = False) -> np.ndarray:
    """[F, 4] scan lines (x0, y0, x1, y1 en face pixel coords, horizontal
    raster protocol) -> [g, g] patch coverage mask.

    flip_y reproduces reverse_y_covered_patches (:42-50) for devices whose
    scan origin is bottom-left.
    """
    g = enface_size // patch_size
    mask = np.zeros((g, g), np.float32)
    for x0, y0, x1, y1 in np.asarray(scan_lines, np.float64):
        y = (y0 + y1) / 2
        for (px, py) in horizontal_line_patches(
                min(x0, x1), max(x0, x1), y, patch_size, coverage,
                grid_limit=enface_size):
            if flip_y:
                py = g - py - 1
            mask[py, px] = 1.0
    return mask


def oct_token_region(oct_res: tuple[int, int, int],
                     image_size=(60, 256, 384), patch_size: int = 16,
                     t_patch_size: int = 3):
    """Device-protocol OCT token sub-grid
    (get_oct_patch_idx_based_on_oct_res, :52-88): which (t, h, w) token
    ranges of the model grid a scan of resolution (frames, depth, width)
    actually covers.  Returns ((t0,t1), (h0,h1), (w0,w1))."""
    tp = (image_size[0] // t_patch_size, image_size[1] // patch_size,
          image_size[2] // patch_size)
    frames, depth, width = oct_res
    d_region = (0, tp[1])
    if width in (384, 768, 1536):
        w_region = (0, tp[2])
    elif width in (512, 1024):
        w_region = (tp[2] // 6, tp[2] - tp[2] // 6)
    else:
        w_region = (0, tp[2])
    if frames in (61, 121):
        t_region = (0, tp[0])
    elif frames in (19,):
        t_region = (tp[0] // 5, tp[0] // 5 + 13)
    else:  # 25 / 48 / 49 / 60 / 97 / 193 and other centered protocols
        t_region = (tp[0] // 10, tp[0] - tp[0] // 10)
    return t_region, d_region, w_region
