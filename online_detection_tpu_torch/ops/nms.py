"""Fixed-size greedy NMS in plain PyTorch (counterpart of ``ops/nms.py``).

Greedy NMS is the unique fixpoint of

    suppressed[j] = any_{i earlier than j} (kept[i] & iou[i, j] > thr)
    kept[i]       = valid[i] & ~suppressed[i]

iterated from ``suppressed = False`` over the boxes in descending score order
(ties broken by original index). Each sweep is one masked [N, N] reduction;
the loop ends at the first sweep that changes nothing. All functions take any
leading batch axes, so one call runs every image's (and every class's) NMS:
``nms`` on [C, N, 4] boxes is the JAX package's ``batched_class_nms``.
"""

from __future__ import annotations

import torch

from online_detection_tpu_torch.utils.boxes import box_iou

NEG_INF = -1e30


def sort_desc(x: torch.Tensor):
    """Descending sort along the last axis, ties broken by lower index (as
    ``jax.lax.top_k`` and a stable ``argsort`` do; ``torch.topk`` does not
    promise that on CUDA)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def top_k(x: torch.Tensor, k: int):
    vals, idx = sort_desc(x)
    return vals[..., :k], idx[..., :k]


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Keep-mask over the input boxes (input order). boxes [..., N, 4],
    scores [..., N], valid [..., N] bool."""
    n = boxes.shape[-2]
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    _, order = sort_desc(masked)
    sboxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    svalid = torch.gather(valid, -1, order)

    iou = box_iou(sboxes, sboxes)  # [..., N, N]
    earlier = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    over = (iou > iou_threshold) & earlier & svalid[..., :, None] & svalid[..., None, :]

    sup = torch.any(over & svalid[..., :, None], dim=-2)
    for _ in range(n):
        kept = svalid & ~sup
        new_sup = torch.any(over & kept[..., :, None], dim=-2)
        if torch.equal(new_sup, sup):
            break
        sup = new_sup
    keep_sorted = svalid & ~sup
    return torch.zeros_like(valid).scatter(-1, order, keep_sorted)


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
        iou_threshold: float, max_out: int):
    """Greedy NMS -> (boxes [..., max_out, 4], scores, valid, idx), sorted by
    descending score; padding rows are invalid with score -1e30 and zero box."""
    n = boxes.shape[-2]
    keep = nms_mask(boxes, scores, valid, iou_threshold)
    kept_scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    k = min(max_out, n)
    top_scores, idx = top_k(kept_scores, k)
    if k < max_out:
        pad = (*top_scores.shape[:-1], max_out - k)
        top_scores = torch.cat([top_scores, top_scores.new_full(pad, NEG_INF)], -1)
        idx = torch.cat([idx, idx.new_zeros(pad)], -1)
    out_valid = top_scores > NEG_INF / 2
    out_boxes = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    out_boxes = out_boxes * out_valid[..., None].to(boxes.dtype)
    out_scores = torch.where(out_valid, top_scores, torch.full_like(top_scores, NEG_INF))
    return out_boxes, out_scores, out_valid, idx

