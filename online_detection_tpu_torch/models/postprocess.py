"""Detection + mask postprocessing, fixed-shape (counterpart of
``models/postprocess.py``).

Per-class decode (no exp clipping) -> one-sided clip -> ``score > -2``
-> per-class NMS 0.3 -> global top-100 across classes, with padded outputs
and validity masks. ``postprocess_detections`` takes a leading image axis.
``postprocess_detections_standalone`` is the cached-boxes variant (one
image): boxes arrive already refined, the clip is two-sided, and ties at the
k-th score are kept.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from online_detection_tpu_torch.ops.nms import nms, top_k
from online_detection_tpu_torch.utils import boxes as box_ops

NEG_INF = -1e30


@dataclass
class Detections:
    boxes: torch.Tensor  # [..., D, 4]
    scores: torch.Tensor  # [..., D]
    labels: torch.Tensor  # [..., D] int32 (1..C; 0 = padding)
    valid: torch.Tensor  # [..., D] bool


def postprocess_detections(
    proposals: torch.Tensor,  # [B, R, 4]
    proposals_valid: torch.Tensor,  # [B, R]
    scores: torch.Tensor,  # [B, R, C+1] (col 0 background)
    deltas: torch.Tensor,  # [B, R, (C+1)*4]
    image_sizes: torch.Tensor,  # [B, 2] (width, height)
    score_thresh: float = -2.0,
    nms_thresh: float = 0.3,
    detections_per_img: int = 100,
    per_class_cap: int = 100,
) -> Detections:
    b, r, n_cls = scores.shape
    refined = box_ops.decode_boxes(deltas, proposals, clip_exp=False)
    refined = box_ops.clip_boxes_one_sided(refined, image_sizes[:, None, :])
    per_class_boxes = refined.reshape(b, r, n_cls, 4).transpose(1, 2)  # [B, C+1, R, 4]
    per_class_scores = scores.transpose(1, 2)  # [B, C+1, R]
    keep = (per_class_scores > score_thresh) & proposals_valid[:, None, :]
    keep[:, 0] = False  # background is never kept

    bx, sc, v, _ = nms(per_class_boxes, per_class_scores, keep,
                       nms_thresh, per_class_cap)  # [B, C+1, cap, ...]
    flat_scores = torch.where(v, sc, torch.full_like(sc, NEG_INF)).reshape(b, -1)
    flat_boxes = bx.reshape(b, -1, 4)
    labels = torch.arange(n_cls, dtype=torch.int32, device=scores.device)
    labels = labels[:, None].expand(n_cls, per_class_cap).reshape(-1)

    top_scores, idx = top_k(flat_scores, detections_per_img)
    out_valid = top_scores > NEG_INF / 2
    boxes = torch.gather(flat_boxes, 1, idx[..., None].expand(*idx.shape, 4))
    return Detections(
        boxes=boxes * out_valid[..., None],
        scores=torch.where(out_valid, top_scores, torch.zeros_like(top_scores)),
        labels=torch.where(out_valid, labels[idx], torch.zeros_like(labels[idx])),
        valid=out_valid,
    )


def postprocess_detections_standalone(
    refined_boxes: torch.Tensor,  # [R, (C+1)*4], class 0 = the raw boxes
    scores: torch.Tensor,  # [R, C+1] (col 0 background)
    valid: torch.Tensor,  # [R]
    image_size: torch.Tensor,  # (width, height)
    score_thresh: float = -2.0,
    nms_thresh: float = 0.3,
    detections_per_img: int = 100,
    per_class_cap: int = 100,
) -> Detections:
    """The standalone postprocessor of the cached-boxes path
    (``OnlineDetectionPostProcessor_standalone.py:10-103``): boxes are
    already refined per class. Unlike ``postprocess_detections`` the clip is
    two-sided, and the global cap keeps every score tied with the k-th
    (``torch.kthvalue`` + ``>=``), so more than ``detections_per_img`` rows may
    survive: the output keeps the full [(C+1) * per_class_cap] rows with a
    validity mask."""
    n_cls = scores.shape[1]
    image_size = torch.as_tensor(image_size, dtype=refined_boxes.dtype,
                                 device=refined_boxes.device)
    boxes = box_ops.clip_boxes_to_image(refined_boxes, image_size)
    per_class_boxes = boxes.reshape(-1, n_cls, 4).transpose(0, 1)  # [C+1, R, 4]
    per_class_scores = scores.T  # [C+1, R]
    keep = (per_class_scores > score_thresh) & valid[None, :]
    keep[0] = False  # background is never kept

    bx, sc, v, _ = nms(per_class_boxes, per_class_scores, keep, nms_thresh, per_class_cap)
    flat_scores = torch.where(v, sc, torch.full_like(sc, NEG_INF)).reshape(-1)
    flat_boxes = bx.reshape(-1, 4)
    labels = torch.arange(n_cls, dtype=torch.int32, device=scores.device)
    labels = labels[:, None].expand(n_cls, per_class_cap).reshape(-1)

    out_valid = flat_scores > NEG_INF / 2
    if 0 < detections_per_img < flat_scores.shape[0]:
        kth = top_k(flat_scores, detections_per_img)[0][-1]
        over = out_valid.sum() > detections_per_img
        out_valid = out_valid & ((flat_scores >= kth) | ~over)
    return Detections(
        boxes=flat_boxes * out_valid[:, None].to(flat_boxes.dtype),
        scores=torch.where(out_valid, flat_scores, torch.zeros_like(flat_scores)),
        labels=torch.where(out_valid, labels, torch.zeros_like(labels)),
        valid=out_valid,
    )


def select_mask_channel(mask_scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """[R, 14, 14, C+1] scores + [R] labels -> [R, 14, 14] sigmoid probs."""
    idx = labels.long()[:, None, None, None].expand(*mask_scores.shape[:3], 1)
    return torch.sigmoid(torch.gather(mask_scores, -1, idx)[..., 0])
