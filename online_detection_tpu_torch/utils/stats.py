"""Feature statistics + z-scoring (counterpart of ``utils/stats.py``).

``zscore`` divides by the mean L2 norm, not by ``std``: the reference computes
``std`` and never uses it, and this port keeps that quirk.

``compute_feature_stats`` is the host route's statistic: the same NumPy draws
and arithmetic as the JAX package's, so with the same generator it gives the
same bits. Only the sampled rows leave the pools' device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from online_detection_tpu_torch.utils.device import host_array


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


def _gather(a, *idx: np.ndarray) -> np.ndarray:
    """``a[idx]`` on the host, where ``a`` is an array or a tensor on any
    device (the rows are gathered there and only they are copied back)."""
    if isinstance(a, torch.Tensor):
        return a[tuple(torch.from_numpy(i).to(a.device) for i in idx)].cpu().numpy()
    return np.asarray(a)[idx]


def compute_feature_stats(
    rng: np.random.Generator,
    positives,  # [C, P, d] masked buffers (array or tensor)
    pos_valid,  # [C, P]
    negatives,  # [C, I, B, d]
    neg_valid,  # [C, I, B]
    num_samples: int = 4000,
    pos_fraction: Optional[float] = None,
    index_fn=None,
) -> FeatureStats:
    """``computeFeatStatistics_torch`` over masked buffers: per class,
    ``ceil(num_samples/C * pos_fraction)`` rows drawn with replacement from
    the valid positives and ``ceil(num_samples/C * (1-pos_fraction) / I)``
    from each batch's valid negatives; empty classes or batches add none.
    Returns CPU tensors: mean, the ``ddof=1`` std that ``zscore`` never
    uses, and the mean L2 norm of the sampled rows.

    ``index_fn(n, size) -> indices`` replaces the with-replacement draws (the
    parity tests pin it)."""
    if index_fn is None:
        index_fn = lambda n, size: rng.integers(0, n, size=size)
    if pos_fraction is None:
        pos_fraction = 0.1
    neg_fraction = 1.0 - pos_fraction

    pv = host_array(pos_valid)
    nv = host_array(neg_valid)
    c = pv.shape[0]
    n_batches = nv.shape[1]
    take_pos = math.ceil((num_samples / c) * pos_fraction)
    take_neg = math.ceil(((num_samples / c) * neg_fraction) / max(n_batches, 1))

    # the draws in the JAX package's order; the rows are gathered in two
    # index operations and put back in that order on the host
    pos_idx, neg_idx, order = [], [], []  # order: (is_neg, first row, n rows)
    n_pos = n_neg = 0
    for i in range(c):
        vidx = np.nonzero(pv[i])[0]
        if len(vidx):
            rows = vidx[np.asarray(index_fn(len(vidx), take_pos))]
            pos_idx.append(np.stack([np.full_like(rows, i), rows]))
            order.append((False, n_pos, len(rows)))
            n_pos += len(rows)
        for j in range(n_batches):
            vj = np.nonzero(nv[i, j])[0]
            if len(vj):
                rows = vj[np.asarray(index_fn(len(vj), take_neg))]
                neg_idx.append(np.stack([np.full_like(rows, i), np.full_like(rows, j), rows]))
                order.append((True, n_neg, len(rows)))
                n_neg += len(rows)
    got_pos = _gather(positives, *np.concatenate(pos_idx, axis=1)) if pos_idx else None
    got_neg = _gather(negatives, *np.concatenate(neg_idx, axis=1)) if neg_idx else None
    sampled = np.concatenate([(got_neg if is_neg else got_pos)[lo:lo + n]
                              for is_neg, lo, n in order], axis=0)
    norms = np.linalg.norm(sampled, axis=1)
    return FeatureStats(
        mean=torch.from_numpy(np.asarray(sampled.mean(0), np.float32)),
        std=torch.from_numpy(np.asarray(sampled.std(0, ddof=1), np.float32)),
        mean_norm=torch.from_numpy(np.asarray(norms.mean(), np.float32)),
    )


def normalize_coxy(x: torch.Tensor, stats: FeatureStats) -> torch.Tensor:
    """``normalize_COXY``: z-scores the X block of the regression set (the
    targets stay as they are)."""
    return zscore(x, stats)
