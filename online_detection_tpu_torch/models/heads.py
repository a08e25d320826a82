"""On-line RoI heads: box predictor and mask predictor (counterpart of
``models/heads.py``).

- ``box_predict``: 2048-d res5 features -> per-class FALKON scores (background
  column fixed at -2) + per-class RLS deltas (background deltas 0). The
  classifiers see z-scored features; the regressors see raw ones unless
  ``normalize_regressor_features``.
- ``mask_deconv``: res5 map -> 2x2/2 transposed conv to 256 ch @ 14x14 -> ReLU.
- ``BoxPredictor`` and ``mask_pretrained_logits``: the stock (pretrained)
  heads that ``detect_pretrained`` runs, linear box predictors and the 1x1
  mask logits.
- ``mask_predict_labels``: per-pixel FALKON of each RoI's own class only, in
  one grouped mmv launch (one group per RoI, its class's centers picked by
  index).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from online_detection_tpu_torch.ops.gaussian_mmv import mmv_grouped
from online_detection_tpu_torch.solvers.falkon import FalkonModel, falkon_predict_classes
from online_detection_tpu_torch.solvers.rls import RLSModel, rls_predict
from online_detection_tpu_torch.utils.stats import FeatureStats, zscore

BACKGROUND_SCORE = -2.0


@dataclass
class OnlineDetectorModels:
    falkon: FalkonModel
    rls: RLSModel
    stats: FeatureStats

    def to(self, device) -> "OnlineDetectorModels":
        return OnlineDetectorModels(self.falkon.to(device), self.rls.to(device),
                                    self.stats.to(device))


@dataclass
class OnlineMaskModels:
    falkon: FalkonModel  # [C, M, 256]
    stats: FeatureStats

    def to(self, device) -> "OnlineMaskModels":
        return OnlineMaskModels(self.falkon.to(device), self.stats.to(device))


class MaskHead(nn.Module):
    """conv5_mask: w [I, O, 2, 2] (ConvTranspose2d layout), b [O]; the stock
    1x1 logits ``logits_w`` [O, K], ``logits_b`` [K]."""

    def __init__(self, w, b, logits_w, logits_b):
        super().__init__()
        for name, t in (("w", w), ("b", b), ("logits_w", logits_w),
                        ("logits_b", logits_b)):
            self.register_buffer(name, t)


class BoxPredictor(nn.Module):
    """The stock box head's linear predictors, in the JAX layout:
    ``cls_w`` [D, C+1], ``cls_b`` [C+1], ``bbox_w`` [D, 4(C+1)], ``bbox_b``
    [4(C+1)]."""

    def __init__(self, cls_w, cls_b, bbox_w, bbox_b):
        super().__init__()
        for name, t in (("cls_w", cls_w), ("cls_b", cls_b), ("bbox_w", bbox_w),
                        ("bbox_b", bbox_b)):
            self.register_buffer(name, t)


def box_predict(models: OnlineDetectorModels, feats: torch.Tensor,
                normalize_regressor_features: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats [R, 2048] -> (scores [R, C+1], deltas [R, (C+1)*4])."""
    r = feats.shape[0]
    z = zscore(feats, models.stats)
    reg_in = z if normalize_regressor_features else feats.float()
    cls = falkon_predict_classes(models.falkon, z, missing_score=BACKGROUND_SCORE)
    deltas = rls_predict(models.rls, reg_in)  # [R, C, 4]
    scores = torch.cat([cls.new_full((r, 1), BACKGROUND_SCORE), cls], dim=1)
    deltas = torch.cat([deltas.new_zeros((r, 1, 4)), deltas], dim=1).reshape(r, -1)
    return scores, deltas


def mask_deconv(head: MaskHead, x: torch.Tensor) -> torch.Tensor:
    """x [R, 7, 7, 2048] -> ReLU(deconv + b) [R, 14, 14, 256] in f32. The
    transposed conv runs in x's dtype; bias and ReLU in f32."""
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), head.w.to(x.dtype), stride=2)
    return torch.relu(out.permute(0, 2, 3, 1).float() + head.b)


def mask_pretrained_logits(head: MaskHead, x: torch.Tensor) -> torch.Tensor:
    """The stock path's 1x1 conv ``mask_fcn_logits``: [R, 14, 14, 256] ->
    [R, 14, 14, C+1] in f32."""
    return x.float() @ head.logits_w + head.logits_b


def mask_predict(models: OnlineMaskModels, deconv_feats: torch.Tensor) -> torch.Tensor:
    """All-class sweep: [R, 14, 14, 256] -> [R, 14, 14, C+1] (background -2)."""
    r, h, w, ch = deconv_feats.shape
    flat = zscore(deconv_feats.reshape(-1, ch), models.stats)
    cls = falkon_predict_classes(models.falkon, flat, missing_score=BACKGROUND_SCORE)
    cls = cls.reshape(r, h, w, -1)
    return torch.cat([cls.new_full((r, h, w, 1), BACKGROUND_SCORE), cls], dim=-1)


def mask_predict_labels(models: OnlineMaskModels, deconv_feats: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """[R, 14, 14] sigmoid probabilities of each RoI's own class; equal to
    ``select_mask_channel(mask_predict(feats), labels)`` at 1/C of the work."""
    r, h, w, ch = deconv_feats.shape
    flat = zscore(deconv_feats.reshape(r, h * w, ch), models.stats)
    cls_idx = (labels.long() - 1).clamp(min=0)
    scores = mmv_grouped(flat, models.falkon.centers, models.falkon.alpha,
                         models.falkon.sigma, set_idx=cls_idx.to(torch.int32))  # [R, P]
    selected = models.falkon.exists[cls_idx] & (labels > 0)
    scores = torch.where(selected[:, None], scores,
                         torch.full_like(scores, BACKGROUND_SCORE))
    return torch.sigmoid(scores).reshape(r, h, w)
