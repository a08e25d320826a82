"""Box geometry with the reference's +1-pixel conventions (torch).

Counterpart of ``online_detection_tpu/utils/boxes.py``: widths are
``x2 - x1 + 1`` in IoU and in the box decoder. Functions act on ``[..., 4]``
(or ``[..., 4*K]``) tensors in ``xyxy`` order.
"""

from __future__ import annotations

import math

import torch

TO_REMOVE = 1.0
# maskrcnn-benchmark clamps exp() args in BoxCoder.decode at log(1000/16)
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return w * h


def box_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: [..., N, 4] x [..., K, 4] -> [..., N, K]."""
    area_a = box_area(boxes_a)
    area_b = box_area(boxes_b)
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = (rb - lt + TO_REMOVE).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def box_iou_masked(boxes_a: torch.Tensor, valid_a: torch.Tensor, boxes_b: torch.Tensor,
                   valid_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU with invalid rows and columns forced to 0."""
    iou = box_iou(boxes_a, boxes_b)
    return iou * valid_a[..., :, None].to(iou.dtype) * valid_b[..., None, :].to(iou.dtype)


def encode_boxes(reference_boxes: torch.Tensor, proposals: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """GT boxes against proposals -> (dx, dy, dw, dh) regression targets
    [..., 4] (BoxCoder.encode, +1 convention; widths floored at 1e-6 so
    inverted padding rows stay finite)."""
    wx, wy, ww, wh = weights
    ex_w = (proposals[..., 2] - proposals[..., 0] + TO_REMOVE).clamp(min=1e-6)
    ex_h = (proposals[..., 3] - proposals[..., 1] + TO_REMOVE).clamp(min=1e-6)
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h
    gt_w = (reference_boxes[..., 2] - reference_boxes[..., 0] + TO_REMOVE).clamp(min=1e-6)
    gt_h = (reference_boxes[..., 3] - reference_boxes[..., 1] + TO_REMOVE).clamp(min=1e-6)
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h
    return torch.stack([wx * (gt_cx - ex_cx) / ex_w, wy * (gt_cy - ex_cy) / ex_h,
                        ww * torch.log(gt_w / ex_w), wh * torch.log(gt_h / ex_h)], dim=-1)


def decode_boxes(
    deltas: torch.Tensor,
    boxes: torch.Tensor,
    weights=(1.0, 1.0, 1.0, 1.0),
    clip_exp: bool = True,
    src_size_offset: float = TO_REMOVE,
) -> torch.Tensor:
    """(dx, dy, dw, dh) deltas [..., 4*K] against boxes [..., 4] -> [..., 4*K].
    ``clip_exp`` clamps dw/dh at log(1000/16) (the RPN's stock coder); the
    on-line detector decode does not. ``src_size_offset`` is the source
    boxes' width convention, ``x2 - x1 + offset``: 1 in the detector, and
    ``np.spacing(1)`` in the standalone ``RegionPredictor``
    (``predict_regions.py:55-56``)."""
    wx, wy, ww, wh = weights
    w = boxes[..., 2] - boxes[..., 0] + src_size_offset
    h = boxes[..., 3] - boxes[..., 1] + src_size_offset
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    dx = deltas[..., 0::4] / wx
    dy = deltas[..., 1::4] / wy
    dw = deltas[..., 2::4] / ww
    dh = deltas[..., 3::4] / wh
    if clip_exp:
        dw = dw.clamp(max=BBOX_XFORM_CLIP)
        dh = dh.clamp(max=BBOX_XFORM_CLIP)

    pred_cx = dx * w[..., None] + cx[..., None]
    pred_cy = dy * h[..., None] + cy[..., None]
    pred_w = torch.exp(dw) * w[..., None]
    pred_h = torch.exp(dh) * h[..., None]

    out = torch.stack(
        [
            pred_cx - 0.5 * pred_w,
            pred_cy - 0.5 * pred_h,
            pred_cx + 0.5 * pred_w - TO_REMOVE,
            pred_cy + 0.5 * pred_h - TO_REMOVE,
        ],
        dim=-1,
    )
    return out.reshape(*deltas.shape[:-1], -1)


def _size_wh(image_size: torch.Tensor):
    """(width, height) with a trailing broadcast axis for [..., K] coords."""
    return image_size[..., 0:1], image_size[..., 1:2]


def clip_boxes_to_image(boxes: torch.Tensor, image_size: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, W-1] x [0, H-1]; ``image_size`` is (width, height), with
    leading axes that broadcast against the box rows' leading axes."""
    w, h = _size_wh(image_size)
    x = torch.minimum(boxes[..., 0::2].clamp(min=0.0), w - TO_REMOVE)
    y = torch.minimum(boxes[..., 1::2].clamp(min=0.0), h - TO_REMOVE)
    return torch.stack([x, y], dim=-1).reshape(*boxes.shape[:-1], -1)


def clip_boxes_one_sided(boxes: torch.Tensor, image_size: torch.Tensor) -> torch.Tensor:
    """The on-line detector's asymmetric clamp: x1/y1 only from below at 0,
    x2/y2 only from above at W-1/H-1."""
    w, h = _size_wh(image_size)
    x1 = boxes[..., 0::4].clamp(min=0.0)
    y1 = boxes[..., 1::4].clamp(min=0.0)
    x2 = torch.minimum(boxes[..., 2::4], w - TO_REMOVE)
    y2 = torch.minimum(boxes[..., 3::4], h - TO_REMOVE)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(*boxes.shape[:-1], -1)


def remove_small_boxes_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return (w >= min_size) & (h >= min_size)
