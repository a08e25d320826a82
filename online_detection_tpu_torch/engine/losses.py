"""Mask R-CNN training losses for the SGD baselines (counterpart of
``engine/losses.py``), fixed-shape.

The stock maskrcnn-benchmark losses of the reference's baseline trainers
(``modeling/rpn/loss.py``, ``box_head/loss.py``, ``mask_head/loss.py``):

- RPN: anchors matched at FG >= 0.7 / BG < 0.3 with low-quality matches
  allowed, 256 samples an image at 0.5 positive fraction; BCE objectness and
  smooth-L1 (beta 1/9) box deltas with unit box-coder weights.
- Box head: proposals (GT appended) matched at 0.5; 512 samples at 0.25
  positive fraction; softmax CE and smooth-L1 on the matched class's deltas
  with (10, 10, 5, 5) weights.
- Mask head: BCE between the sampled class's channel and the 14x14-projected
  GT mask, over the positive samples.

Sampling is a masked random-priority sort (fixed shapes). Its uniforms are
injectable: ``balanced_sample`` takes ``uniforms=(u_pos, u_neg)``, or draws
them from a caller's ``torch.Generator`` (``utils/draws.py``). Sorts are
stable and ``argmax`` keeps the first maximum, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from online_detection_tpu_torch.utils import boxes as box_ops
from online_detection_tpu_torch.utils.draws import uniform, valid_first


def smooth_l1(x: torch.Tensor, beta: float) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _relu(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` whose gradient at 0 is 1/2, as ``jnp.maximum``'s is."""
    return torch.maximum(x, x.new_zeros(()))


def _first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first maximum along ``dim`` (``jnp.argmax``'s tie rule)."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    pos = torch.arange(n, device=x.device).reshape(shape)
    is_max = x == x.amax(dim=dim, keepdim=True)
    return torch.where(is_max, pos, torch.full_like(pos, n)).amin(dim=dim)


def match_boxes(iou: torch.Tensor, high: float, low: float,
                allow_low_quality: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """maskrcnn Matcher on iou [G, N] (invalid GTs at -1): each column's best
    GT, labels 1 (fg), 0 (bg), -1 (between). Low quality: every GT's best
    column(s) become fg. -> (matched_gt [N], labels [N])."""
    best = iou.amax(dim=0)
    arg = _first_argmax(iou, 0)
    one, zero, neg = (torch.full_like(arg, v) for v in (1, 0, -1))
    labels = torch.where(best >= high, one, torch.where(best < low, zero, neg))
    if allow_low_quality:
        per_gt_best = iou.amax(dim=1, keepdim=True)
        rescue = ((iou == per_gt_best) & (per_gt_best > 0)).any(dim=0)
        labels = torch.where(rescue, one, labels)
    return arg, labels


def balanced_sample(labels: torch.Tensor, num: int, pos_fraction: float,
                    uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    generator: Optional[torch.Generator] = None):
    """Random positive / negative subsample of labels [N] in {-1, 0, 1} ->
    (mask_pos [N], mask_neg [N]). Each pool ranks its members by a uniform
    draw (``uniforms`` as given, else from ``generator``) and keeps the first
    ``n_take``."""
    pos = labels == 1
    neg = labels == 0
    n_pos = torch.clamp(pos.sum(), max=int(num * pos_fraction))
    n_neg = torch.minimum(neg.sum(), num - n_pos)
    if uniforms is None:
        uniforms = tuple(uniform(labels.shape, generator, labels.device) for _ in range(2))

    def pick(u, mask, n_take):
        pri = torch.as_tensor(u, dtype=torch.float32, device=labels.device) - mask * 2.0
        order = torch.sort(pri, stable=True).indices
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.shape[0], device=order.device)
        return mask & (rank < n_take)

    return pick(uniforms[0], pos, n_pos), pick(uniforms[1], neg, n_neg)


def rpn_loss(logits: torch.Tensor, deltas: torch.Tensor, anchors: torch.Tensor,
             visibility: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
             batch_per_image: int = 256, pos_fraction: float = 0.5, uniforms=None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits [N_anchors], deltas [N_anchors, 4] -> objectness BCE + box
    smooth-L1 over the sampled anchors."""
    iou = box_ops.box_iou(gt_boxes, anchors)
    iou = torch.where(gt_valid[:, None], iou, torch.full_like(iou, -1.0))
    matched, labels = match_boxes(iou, 0.7, 0.3, allow_low_quality=True)
    labels = torch.where(visibility, labels, torch.full_like(labels, -1))  # straddle filter
    pos_m, neg_m = balanced_sample(labels, batch_per_image, pos_fraction, uniforms, generator)
    sampled = pos_m | neg_m
    n = sampled.sum().clamp(min=1)

    targets = box_ops.encode_boxes(gt_boxes[matched], anchors)
    reg = smooth_l1(deltas - targets, beta=1.0 / 9.0).sum(-1)
    reg_loss = (reg * pos_m).sum() / n
    ce = _relu(logits) - logits * (labels == 1) + torch.log1p(torch.exp(-logits.abs()))
    cls_loss = (ce * sampled).sum() / n
    return cls_loss + reg_loss


class ROISample(NamedTuple):
    boxes: torch.Tensor  # [S, 4]
    labels: torch.Tensor  # [S] (0 = background)
    matched_gt: torch.Tensor  # [S]
    valid: torch.Tensor  # [S]
    is_pos: torch.Tensor  # [S]


def sample_rois(proposals: torch.Tensor, prop_valid: torch.Tensor, gt_boxes: torch.Tensor,
                gt_labels: torch.Tensor, gt_valid: torch.Tensor, batch_per_image: int = 512,
                pos_fraction: float = 0.25, uniforms=None,
                generator: Optional[torch.Generator] = None) -> ROISample:
    """FastRCNN subsampling of proposals [P, 4] (GT boxes appended upstream)."""
    iou = box_ops.box_iou(gt_boxes, proposals)
    iou = torch.where(gt_valid[:, None] & prop_valid[None, :], iou, torch.full_like(iou, -1.0))
    matched, mlabels = match_boxes(iou, 0.5, 0.5, allow_low_quality=False)
    mlabels = torch.where(prop_valid, mlabels, torch.full_like(mlabels, -1))
    pos_m, neg_m = balanced_sample(mlabels, batch_per_image, pos_fraction, uniforms, generator)
    idx, valid = _compact_idx(pos_m | neg_m, batch_per_image)
    is_pos = pos_m[idx] & valid
    labels = torch.where(is_pos, gt_labels[matched[idx]].long(), torch.zeros_like(idx))
    return ROISample(boxes=proposals[idx], labels=labels, matched_gt=matched[idx], valid=valid,
                     is_pos=is_pos)


def _compact_idx(mask: torch.Tensor, n_out: int):
    """The True entries first (stable), ``n_out`` of them, the last index
    repeated past the end -> (idx [n_out], valid [n_out])."""
    n = mask.shape[0]
    order = valid_first(mask)
    idx = order[torch.clamp(torch.arange(n_out, device=mask.device), max=n - 1)]
    return idx, torch.arange(n_out, device=mask.device) < torch.clamp(mask.sum(), max=n_out)


def box_head_loss(cls_logits: torch.Tensor, box_deltas: torch.Tensor, sample: ROISample,
                  gt_boxes: torch.Tensor) -> torch.Tensor:
    """cls_logits [S, C+1], box_deltas [S, 4(C+1)] -> softmax CE over the
    valid samples + smooth-L1 of the positives' class deltas."""
    n = sample.valid.sum().clamp(min=1)
    logp = torch.log_softmax(cls_logits, dim=-1)
    ce = -logp.gather(1, sample.labels[:, None])[:, 0]
    cls_loss = (ce * sample.valid).sum() / n

    targets = box_ops.encode_boxes(gt_boxes[sample.matched_gt], sample.boxes,
                                   weights=(10.0, 10.0, 5.0, 5.0))
    per_class = box_deltas.reshape(box_deltas.shape[0], -1, 4)
    sel = per_class.gather(1, sample.labels[:, None, None].expand(-1, 1, 4))[:, 0]
    reg = smooth_l1(sel - targets, beta=1.0).sum(-1)
    return cls_loss + (reg * sample.is_pos).sum() / n


def mask_head_loss(mask_logits: torch.Tensor, sample: ROISample,
                   gt_masks_14: torch.Tensor) -> torch.Tensor:
    """mask_logits [S, 14, 14, C+1], gt_masks_14 [S, 14, 14] -> per-pixel BCE
    of each positive sample's class channel."""
    idx = sample.labels[:, None, None, None].expand(*mask_logits.shape[:3], 1)
    sel = mask_logits.gather(-1, idx)[..., 0]
    ce = (_relu(sel) - sel * gt_masks_14 + torch.log1p(torch.exp(-sel.abs()))).mean(dim=(1, 2))
    n = sample.is_pos.sum().clamp(min=1)
    return (ce * sample.is_pos).sum() / n
