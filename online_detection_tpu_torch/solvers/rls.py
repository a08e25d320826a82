"""RLS box refiners, prediction side (counterpart of ``solvers/rls.py``).

``Y = ([X, 1] @ Beta) @ T_inv + mu`` per class, in IEEE fp32 (box deltas are
O(0.1) while ``|x| * |beta|`` is O(10^2), so a reduced-precision product
lands on the deltas at full size). The fit is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class RLSModel:
    """beta [C, d+1, 4]; t_inv, t [C, 4, 4]; mu [C, 4]; exists [C];
    mean_losses [C, 4]."""

    beta: torch.Tensor
    t_inv: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor
    exists: torch.Tensor
    mean_losses: torch.Tensor

    def to(self, device) -> "RLSModel":
        return RLSModel(*(getattr(self, f).to(device) for f in
                          ("beta", "t_inv", "t", "mu", "exists", "mean_losses")))


def rls_predict(model: RLSModel, x: torch.Tensor) -> torch.Tensor:
    """[N, d] -> [N, C, 4]; classes without a model predict zero deltas."""
    yw = torch.einsum("nd,cdk->nck", x, model.beta[:, :-1, :]) + model.beta[:, -1, :][None]
    out = torch.einsum("nck,ckl->ncl", yw, model.t_inv) + model.mu[None]
    return torch.where(model.exists[None, :, None], out, torch.zeros_like(out))
