"""Host-side GT-mask projection (a copy of the JAX package's
``data/mask_project.py``, NumPy).

Crops a binary mask to a box and resamples it to out x out with a separable
bilinear sampler, so the harvest uploads [G, 14, 14] floats per image
instead of canvas-resolution masks. The box is in the mask's coordinate
frame; for canvas-frame boxes with original-resolution masks pass
``box / scale``.
"""

from __future__ import annotations

import numpy as np


def _axis_weights(start: float, size: float, dim: int, out: int) -> np.ndarray:
    ks = np.arange(out, dtype=np.float64)
    pos = np.clip(start + (ks + 0.5) / out * size - 0.5, 0.0, dim - 1.0)
    low = np.floor(pos)
    frac = pos - low
    grid = np.arange(dim, dtype=np.float64)[None, :]
    w_low = (grid == low[:, None]) * (1.0 - frac[:, None])
    w_high = (grid == low[:, None] + 1.0) * frac[:, None]
    return (w_low + w_high).astype(np.float32)  # [out, dim]


def _rows(wy: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """``wy @ mask`` for bilinear weights wy [out, H] (at most two adjacent
    non-zeros a row) and a 0/1 mask [H, W], from the two rows each output
    row reads: each product is exact and each sum rounds once, so this is
    the BLAS product bit for bit, without waking a BLAS thread pool on a
    [out, H] x [H, W] product."""
    h = mask.shape[0]
    low = np.argmax(wy != 0, axis=1)  # the first non-zero (0 for a zero row)
    high = np.minimum(low + 1, h - 1)
    rows = np.arange(wy.shape[0])
    w_high = np.where(high > low, wy[rows, high], np.float32(0))
    return wy[rows, low][:, None] * mask[low] + w_high[:, None] * mask[high]


def project_mask_on_box_np(mask: np.ndarray, box, out: int = 14) -> np.ndarray:
    """mask [H, W] (0/1), box (x1, y1, x2, y2) -> [out, out] float32."""
    h, w = mask.shape
    x1, y1, x2, y2 = [float(v) for v in box]
    wy = _axis_weights(y1, max(y2 - y1 + 1.0, 1.0), h, out)
    wx = _axis_weights(x1, max(x2 - x1 + 1.0, 1.0), w, out)
    return _rows(wy, mask.astype(np.float32)) @ wx.T


def project_masks_for_image(masks: np.ndarray, boxes_canvas: np.ndarray, scale: float,
                            gt_cap: int, out: int = 14) -> np.ndarray:
    """masks [G0, H0, W0] at the original resolution, boxes [G, 4] in the
    canvas frame -> [gt_cap, out, out] float32 (zero past the valid GTs)."""
    g = min(len(masks), len(boxes_canvas), gt_cap)
    result = np.zeros((gt_cap, out, out), np.float32)
    for j in range(g):
        result[j] = project_mask_on_box_np(masks[j], np.asarray(boxes_canvas[j]) / scale, out)
    return result
