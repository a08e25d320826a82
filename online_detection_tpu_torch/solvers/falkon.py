"""FALKON: Nystrom kernel ridge regression (counterpart of
``solvers/falkon.py``).

Fit: solve ``(K_NM^T W K_NM / n + lam K_MM) alpha = K_NM^T W y / n`` with
FALKON's Cholesky preconditioner ``T = chol(K_MM + eps M I)``,
``A = chol(T T^T / M + lam I)``, ``B = T^-1 A^-1``, as the direct solve of
``P beta = B^T b`` with ``P = Z^T W Z / n + lam S^T S``, ``Z = K_NM B``,
``S = A^-1`` (PSD by construction), ``alpha = B beta``: the fixpoint the
reference's 20-step CG approaches. Every function takes a leading class
axis. All products run in IEEE fp32 (the caller keeps TF32 off,
``utils.device.ieee_fp32``); plain large products are ``torch.matmul``.

A Cholesky of a matrix that is not positive definite gives NaN for that
class only, as in the JAX package (``torch.linalg.cholesky_ex``, no host
sync), instead of raising.

Prediction: ``K(x, centers) @ alpha`` through the grouped Gaussian mmv; a
class without a model (``exists`` False) scores ``missing_score`` (-2, as in
the reference).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from online_detection_tpu_torch.ops.gaussian_mmv import gaussian_kernel, mmv, mmv_grouped
from online_detection_tpu_torch.utils.draws import randint_below, valid_first

EPS_JITTER = 1e-6  # scaled by M on the K_MM diagonal, like falkon's pc_epsilon


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


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each matrix of ``a``; NaN where one is not
    positive definite."""
    low, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], low, torch.full_like(low, float("nan")))


def select_nystrom_centers(is_pos: torch.Tensor, valid: torch.Tensor, m: int,
                           generator=None, draws=None, uniforms=None) -> torch.Tensor:
    """[..., m] row indices: at most m // 2 positives (all of them if fewer,
    else drawn with replacement), the rest negatives likewise; leftover
    slots repeat the first choice. is_pos broadcasts against valid [..., N].
    ``draws``: (positive, negative) index draws [..., m] each; ``uniforms``
    [..., 2, m]: the uniforms those index draws are made from."""
    n = valid.shape[-1]
    pos_valid = is_pos & valid
    neg_valid = ~is_pos & valid
    n_pos = pos_valid.sum(-1, keepdim=True)
    n_neg = neg_valid.sum(-1, keepdim=True)
    order_pos, order_neg = valid_first(pos_valid), valid_first(neg_valid)
    half = m // 2
    n_pos_sel = n_pos.clamp(max=half)
    n_neg_sel = torch.minimum(n_neg, m - n_pos_sel)
    pd, nd = (None, None) if draws is None else draws
    pu, nu = (None, None) if uniforms is None else uniforms.unbind(-2)
    rand_pos = randint_below(n_pos.clamp(min=1), m, generator, pd, pu)
    rand_neg = randint_below(n_neg.clamp(min=1), m, generator, nd, nu)

    slot = torch.arange(m, device=valid.device)
    pos_take = torch.where(n_pos > half, rand_pos, torch.minimum(slot, (n_pos - 1).clamp(min=0)))
    pos_rows = order_pos.gather(-1, pos_take.clamp(0, n - 1))
    t = slot - n_pos_sel
    neg_take = torch.where(n_neg > m - n_pos_sel, rand_neg,
                           torch.minimum(t, (n_neg - 1).clamp(min=0)))
    neg_rows = order_neg.gather(-1, neg_take.clamp(0, n - 1))
    idx = torch.where(slot < n_pos_sel, pos_rows, neg_rows)
    total = n_pos_sel + n_neg_sel
    return torch.where(slot < total.clamp(min=1), idx, idx[..., :1])


def falkon_fit(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, centers: torch.Tensor,
               sigma: float, lam: float) -> torch.Tensor:
    """x [C, N, d] (normalized), y [N] or [C, N] (+-1), w [C, N] 0/1 weights,
    centers [C, M, d] -> alpha [C, M]."""
    m = centers.shape[-2]
    w = w.float()
    n = w.sum(-1).clamp(min=1.0)[..., None, None]
    eye = torch.eye(m, dtype=torch.float32, device=x.device)
    k_mm = gaussian_kernel(centers, centers, sigma)
    t_low = cholesky_or_nan(k_mm + EPS_JITTER * m * eye)
    a_low = cholesky_or_nan(t_low.mT @ t_low / m + lam * eye)
    # S = A^-T, B = T^-T S: the preconditioner applied to the identity
    s_mat = torch.linalg.solve_triangular(a_low.mT, eye.expand_as(a_low), upper=True)
    b_mat = torch.linalg.solve_triangular(t_low.mT, s_mat, upper=True)
    z = gaussian_kernel(x, centers, sigma) @ b_mat  # [C, N, M]
    p_mat = (z * w[..., None]).mT @ z / n + lam * (s_mat.mT @ s_mat)
    p_mat = 0.5 * (p_mat + p_mat.mT)
    b_rhs = ((y.float() * w)[..., None, :] @ z).mT / n  # [C, M, 1]
    beta = torch.cholesky_solve(b_rhs, cholesky_or_nan(p_mat))
    return (b_mat @ beta)[..., 0]


def direct_nystrom_solve(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                         centers: torch.Tensor, sigma: float, lam: float) -> torch.Tensor:
    """Dense solve of the same normal equations, for tests on small problems:
    x [N, d], centers [M, d] -> alpha [M]."""
    k_nm = gaussian_kernel(x, centers, sigma) * w[:, None]
    n = w.sum().clamp(min=1.0)
    h = k_nm.T @ k_nm / n + lam * gaussian_kernel(centers, centers, sigma)
    return torch.linalg.solve(h, k_nm.T @ (y * w) / n)
