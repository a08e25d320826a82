"""RPN: shared conv, pretrained and on-line heads, and the proposal stage
(counterpart of ``models/rpn.py``).

``propose`` takes a leading image axis: one call ranks, decodes, clips and
runs NMS for every image of the batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from online_detection_tpu_torch.ops.nms import nms, top_k
from online_detection_tpu_torch.solvers.falkon import FalkonModel, falkon_predict_classes
from online_detection_tpu_torch.solvers.rls import RLSModel, rls_predict
from online_detection_tpu_torch.utils import boxes as box_ops
from online_detection_tpu_torch.utils.stats import FeatureStats, zscore


@dataclass
class OnlineRPNModels:
    """15 per-anchor-shape FALKON classifiers, 15 RLS refiners, and the
    statistics for z-scoring."""

    falkon: FalkonModel
    rls: RLSModel
    stats: FeatureStats

    def to(self, device) -> "OnlineRPNModels":
        return OnlineRPNModels(self.falkon.to(device), self.rls.to(device),
                               self.stats.to(device))


class RPNHead(nn.Module):
    """conv_w [C, C, 3, 3] (OIHW), conv_b [C]; 1x1 heads cls_w [C, A],
    bbox_w [C, 4A] with biases."""

    def __init__(self, conv_w, conv_b, cls_w, cls_b, bbox_w, bbox_b):
        super().__init__()
        for name, t in (("conv_w", conv_w), ("conv_b", conv_b), ("cls_w", cls_w),
                        ("cls_b", cls_b), ("bbox_w", bbox_w), ("bbox_b", bbox_b)):
            self.register_buffer(name, t)


def rpn_features(head: RPNHead, c4: torch.Tensor) -> torch.Tensor:
    """3x3 conv + ReLU on C4 [N, H, W, C] -> [N, H, W, C], in c4's dtype."""
    x = c4.permute(0, 3, 1, 2)
    out = F.conv2d(x, head.conv_w.to(x.dtype), padding=1)
    out = torch.relu(out + head.conv_b.to(x.dtype)[:, None, None])
    return out.permute(0, 2, 3, 1)


def rpn_pretrained(head: RPNHead, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """t [N, H, W, C] -> logits [N, H, W, A], deltas [N, H, W, 4A] (f32)."""
    tf = t.float()
    return tf @ head.cls_w + head.cls_b, tf @ head.bbox_w + head.bbox_b


def rpn_online_flat(models: OnlineRPNModels, flat: torch.Tensor):
    """Flat conv-feature rows [N, C] -> (scores [N, A], deltas [N, A, 4]).
    Features are z-scored once and shared by classifiers and refiners."""
    flat = zscore(flat, models.stats)
    return falkon_predict_classes(models.falkon, flat), rls_predict(models.rls, flat)


def rpn_online(models: OnlineRPNModels, t: torch.Tensor):
    """One image's conv features t [H, W, C] -> ([H*W, A], [H*W, A, 4])."""
    h, w, ch = t.shape
    return rpn_online_flat(models, t.reshape(h * w, ch))


def propose(
    scores: torch.Tensor,  # [B, HW*A] raw objectness
    deltas: torch.Tensor,  # [B, HW*A, 4]
    anchors: torch.Tensor,  # [HW*A, 4]
    image_sizes: torch.Tensor,  # [B, 2] (width, height)
    pre_nms_top_n: int = 1000,
    post_nms_top_n: int = 300,
    nms_thresh: float = 0.7,
    min_size: float = 0.0,
):
    """top-k -> decode (clipped exp) -> clip -> NMS -> top ``post_nms_top_n``:
    (boxes [B, post, 4], sigmoid objectness [B, post], valid [B, post])."""
    k = min(pre_nms_top_n, scores.shape[-1])
    top_scores, idx = top_k(scores, k)
    top_deltas = torch.gather(deltas, 1, idx[..., None].expand(*idx.shape, 4))
    top_anchors = anchors[idx]
    boxes = box_ops.decode_boxes(top_deltas, top_anchors, clip_exp=True)
    boxes = box_ops.clip_boxes_to_image(boxes, image_sizes[:, None, :])
    valid = box_ops.remove_small_boxes_mask(boxes, min_size)
    out_boxes, out_scores, out_valid, _ = nms(boxes, top_scores, valid, nms_thresh,
                                              post_nms_top_n)
    return out_boxes, torch.sigmoid(out_scores), out_valid
