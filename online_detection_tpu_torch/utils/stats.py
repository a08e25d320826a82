"""Feature statistics + z-scoring (counterpart of ``utils/stats.py``).

``zscore`` divides by the mean L2 norm, not by ``std``: the reference computes
``std`` and never uses it, and this port keeps that quirk.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class FeatureStats:
    mean: torch.Tensor  # [d]
    std: torch.Tensor  # [d] stored, unused by zscore
    mean_norm: torch.Tensor  # scalar

    def to(self, device) -> "FeatureStats":
        return FeatureStats(self.mean.to(device), self.std.to(device),
                            self.mean_norm.to(device))


def zscore(x: torch.Tensor, stats: FeatureStats, target_norm: float = 20.0) -> torch.Tensor:
    """(x - mean) * (target_norm / mean_norm). A bf16 ``x`` minus the f32
    mean promotes to f32, as in the JAX package."""
    return (x - stats.mean) * (target_norm / stats.mean_norm)
