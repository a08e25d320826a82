"""Image preprocessing with the reference's Caffe2 conventions.

The size arithmetic and ``preprocess_image_u8`` are a copy of the JAX
package's ``data/transforms.py`` (NumPy, host side); ``normalize_canvas`` is
its torch counterpart and runs on the tensor's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

PIXEL_MEAN_BGR = np.array([102.9801, 115.9465, 122.7750], np.float32)


def resize_scale(w: int, h: int, min_size: int = 600, max_size: int = 1333) -> float:
    size = min_size
    mx, mn = max(w, h), min(w, h)
    if mx / mn * size > max_size:
        size = int(round(max_size * mn / mx))
    if (w <= h and w == size) or (h <= w and h == size):
        return 1.0
    return size / mn


def scaled_size(w: int, h: int, min_size: int = 600,
                max_size: int = 1333) -> Tuple[int, int]:
    """(scaled_w, scaled_h); the long side is truncated, as the reference's
    resize paths do."""
    size = min_size
    mx, mn = max(w, h), min(w, h)
    if mx / mn * size > max_size:
        size = int(round(max_size * mn / mx))
    if (w <= h and w == size) or (h <= w and h == size):
        return w, h
    if w < h:
        return size, int(size * h / w)
    return int(size * w / h), size


def canvas_size(w: int, h: int, min_size: int = 600, max_size: int = 1333,
                divisibility: int = 32) -> Tuple[int, int]:
    """(canvas_h, canvas_w): scaled, then rounded up to /32."""
    sw, sh = scaled_size(w, h, min_size, max_size)
    pad = lambda v: (v + divisibility - 1) // divisibility * divisibility
    return pad(sh), pad(sw)


def preprocess_image_u8(rgb: np.ndarray, canvas_hw: Tuple[int, int], min_size: int = 600,
                        max_size: int = 1333):
    """uint8 RGB [H, W, 3] -> (uint8 canvas [ch, cw, 3], scale, (scaled_w,
    scaled_h)): resize and pad only; BGR and the mean subtraction happen on
    the device (``normalize_canvas``). PIL is imported only where a resize is
    needed."""
    h, w = rgb.shape[:2]
    s = resize_scale(w, h, min_size, max_size)
    sw, sh = scaled_size(w, h, min_size, max_size)
    if (sw, sh) != (w, h):
        import PIL.Image as PILImage

        rgb = np.asarray(PILImage.fromarray(rgb).resize((sw, sh), PILImage.BILINEAR))
    ch, cw = canvas_hw
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[: min(sh, ch), : min(sw, cw)] = rgb[:ch, :cw]
    return canvas, s, (sw, sh)


def normalize_canvas(canvas: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [..., 3] -> f32 BGR minus pixel means. Float input is taken
    as already normalized and returned unchanged."""
    if canvas.dtype == torch.uint8:
        bgr = canvas.flip(-1).to(torch.float32)
        return bgr - torch.as_tensor(PIXEL_MEAN_BGR, device=canvas.device)
    return canvas


def scale_boxes(boxes: np.ndarray, scale: float) -> np.ndarray:
    return boxes * scale
