"""FALKON prediction (counterpart of ``solvers/falkon.py``'s predict side).

Scores are ``K(x, centers) @ alpha`` through the grouped Gaussian mmv; a
class without a model (``exists`` False) scores ``missing_score`` (-2, as in
the reference). The fit is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from online_detection_tpu_torch.ops.gaussian_mmv import mmv, mmv_grouped


@dataclass
class FalkonModel:
    """A batch of fitted classifiers: centers [..., M, d], alpha [..., M],
    exists [...] bool, and the kernel width ``sigma`` (a Python float)."""

    centers: torch.Tensor
    alpha: torch.Tensor
    exists: torch.Tensor
    sigma: float

    def to(self, device) -> "FalkonModel":
        return FalkonModel(self.centers.to(device), self.alpha.to(device),
                           self.exists.to(device), self.sigma)


def falkon_predict(model: FalkonModel, x: torch.Tensor,
                   missing_score: float = -2.0) -> torch.Tensor:
    """One classifier: x [N, d] -> [N]."""
    scores = mmv(x, model.centers, model.alpha, model.sigma)
    return torch.where(model.exists, scores, torch.full_like(scores, missing_score))


def falkon_predict_classes(models: FalkonModel, x: torch.Tensor,
                           missing_score: float = -2.0) -> torch.Tensor:
    """x [N, d] against C classifiers -> [N, C], in one kernel launch."""
    scores = mmv_grouped(x, models.centers, models.alpha, models.sigma)  # [C, N]
    scores = torch.where(models.exists[:, None], scores,
                         torch.full_like(scores, missing_score))
    return scores.T
