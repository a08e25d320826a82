"""Anchor grid generation with Detectron's rounding (NumPy).

A copy of the JAX package's ``models/anchors.py`` functions that inference
and the harvest pass need: 15 anchors per location (5 sizes x 3 ratios, ratio-major), stride 16,
grid ordered (y, x, anchor).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def base_anchors(
    stride: int = 16,
    sizes: Sequence[int] = (32, 64, 128, 256, 512),
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
) -> np.ndarray:
    """[A, 4] ratio-major base anchors, xyxy with the +1 convention."""
    scales = np.asarray(sizes, np.float64) / stride
    base = np.array([0, 0, stride - 1, stride - 1], np.float64)

    def whctr(a):
        w = a[2] - a[0] + 1
        h = a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mkanchors(ws, hs, cx, cy):
        ws = ws[:, None]
        hs = hs[:, None]
        return np.hstack([
            cx - 0.5 * (ws - 1),
            cy - 0.5 * (hs - 1),
            cx + 0.5 * (ws - 1),
            cy + 0.5 * (hs - 1),
        ])

    w, h, cx, cy = whctr(base)
    size_ratios = (w * h) / np.asarray(ratios, np.float64)
    ws = np.round(np.sqrt(size_ratios))  # Detectron rounds here
    hs = np.round(ws * np.asarray(ratios, np.float64))
    ratio_anchors = mkanchors(ws, hs, cx, cy)

    out = []
    for i in range(ratio_anchors.shape[0]):
        w, h, cx, cy = whctr(ratio_anchors[i])
        out.append(mkanchors(w * scales, h * scales, cx, cy))
    return np.vstack(out).astype(np.float32)


def grid_anchors(
    feat_h: int,
    feat_w: int,
    stride: int = 16,
    sizes: Sequence[int] = (32, 64, 128, 256, 512),
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
) -> np.ndarray:
    """Full anchor grid [H*W*A, 4], location-major, anchor fastest."""
    cell = base_anchors(stride, sizes, ratios)
    sx = np.arange(feat_w, dtype=np.float32) * stride
    sy = np.arange(feat_h, dtype=np.float32) * stride
    shift_x, shift_y = np.meshgrid(sx, sy)
    shifts = np.stack([shift_x, shift_y, shift_x, shift_y], axis=-1).reshape(-1, 1, 4)
    return (shifts + cell[None]).reshape(-1, 4)


def anchor_visibility(anchors: np.ndarray, image_size: Tuple[int, int],
                      straddle_thresh: float = 0.0) -> np.ndarray:
    """Straddle filter: anchors inside the true (width, height) image."""
    w, h = image_size
    if straddle_thresh < 0:
        return np.ones(anchors.shape[0], bool)
    return ((anchors[:, 0] >= -straddle_thresh) & (anchors[:, 1] >= -straddle_thresh)
            & (anchors[:, 2] < w + straddle_thresh) & (anchors[:, 3] < h + straddle_thresh))
