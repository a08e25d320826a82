"""RLS box refiners: ridge regression with target whitening (counterpart of
``solvers/rls.py``).

Fit, per class: append a bias column, center the 4-d targets (mu) and
whiten them with the inverse square root of their covariance (eigenvalues
floored at +0.001), then solve ``(X^T X + lam I) beta = X^T Yw``. The Gram
and moment pass is one batched product over all classes in IEEE fp32.
``rls_fit`` solves on the host in float64, as the reference does;
``rls_fit_grouped(device_solve=True)`` solves on the device in fp32: Jacobi
equilibration, a Cholesky with escalating jitter {0, 3e-5, 3e-3, a
Gershgorin bound} picked per class without a host sync, and one step of
iterative refinement.

Prediction: ``Y = ([X, 1] @ Beta) @ T_inv + mu`` per class, in IEEE fp32 (box
deltas are O(0.1) while ``|x| * |beta|`` is O(10^2), so a reduced-precision
product lands on the deltas at full size).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from online_detection_tpu_torch.solvers.falkon import cholesky_or_nan
from online_detection_tpu_torch.utils.draws import valid_first

_BLOCK_BYTES_LIMIT = 2 * 1024**3  # no per-class compaction past this


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


def _gram_stats(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """Masked Gram and moment statistics per class: x [C, N, d], y [C, N, 4],
    w [C, N] -> (G [C, d+1, d+1] with the bias row and column, b = X1^T y
    [C, d+1, 4], sum_y [C, 4], yty [C, 4, 4], n [C])."""
    wf = w.float()[..., None]
    xm, ym = x * wf, y * wf
    c, _, d = x.shape
    sum_x = xm.sum(1)
    n = wf[..., 0].sum(1)
    g = x.new_empty((c, d + 1, d + 1))
    g[:, :d, :d] = xm.mT @ x
    g[:, :d, d] = sum_x
    g[:, d, :d] = sum_x
    g[:, d, d] = n
    sum_y = ym.sum(1)
    b = torch.cat([xm.mT @ y, sum_y[:, None, :]], dim=1)
    return g, b, sum_y, ym.mT @ y, n


def _solve_from_stats(g, b, sum_y, yty, n, lam: float) -> RLSModel:
    """Host float64 whitening and ridge solves (LU) from the Gram statistics;
    classes with no rows keep zeros and ``exists`` False."""
    dev = g.device
    g, b, sum_y, yty, n = (t.detach().to("cpu", torch.float64) for t in (g, b, sum_y, yty, n))
    c, dp1 = g.shape[0], g.shape[1]
    beta = torch.zeros((c, dp1, 4), dtype=torch.float64)
    t_all = torch.zeros((c, 4, 4), dtype=torch.float64)
    t_inv_all = torch.zeros_like(t_all)
    mu_all = torch.zeros((c, 4), dtype=torch.float64)
    mean_losses = torch.zeros((c, 4), dtype=torch.float64)
    exists = n >= 1
    for i in range(c):
        ni = float(n[i])
        if ni < 1:
            continue
        mu = sum_y[i] / ni
        s = (yty[i] - ni * torch.outer(mu, mu)) / ni
        dvals, wvecs = torch.linalg.eigh(s)
        dvals = dvals.clamp(min=0.0)
        t = wvecs @ torch.diag(1.0 / torch.sqrt(dvals + 0.001)) @ wvecs.T
        t_inv = wvecs @ torch.diag(torch.sqrt(dvals + 0.001)) @ wvecs.T
        bw = (b[i] - torch.outer(g[i][:, -1], mu)) @ t
        beta[i] = torch.linalg.solve(g[i] + lam * torch.eye(dp1, dtype=torch.float64), bw)
        ywty = t.T @ (yty[i] - ni * torch.outer(mu, mu)) @ t
        sq = (torch.einsum("dk,de,ek->k", beta[i], g[i], beta[i])
              - 2.0 * (beta[i] * bw).sum(0) + torch.diagonal(ywty))
        mean_losses[i] = 0.5 * sq / ni
        t_all[i], t_inv_all[i], mu_all[i] = t, t_inv, mu
    f32 = lambda t: t.to(dev, torch.float32)
    return RLSModel(f32(beta), f32(t_inv_all), f32(t_all), f32(mu_all), exists.to(dev),
                    f32(mean_losses))


def rls_fit(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, lam: float) -> RLSModel:
    """All C refiners from per-class buffers x [C, N, d], y [C, N, 4], w [C, N]:
    device Gram pass, host float64 solves."""
    return _solve_from_stats(*_gram_stats(x, y, w), lam)


def _class_counts(cls1: torch.Tensor, w: torch.Tensor, num_classes: int) -> torch.Tensor:
    lab = cls1.long() - 1
    ok = (w > 0) & (lab >= 0) & (lab < num_classes)
    return torch.zeros(num_classes, dtype=torch.long, device=w.device).index_add_(
        0, lab.clamp(0, num_classes - 1), ok.long())


def _compact_class_blocks(x, y, cls1, w, num_classes: int, cap: int):
    """Each class's valid rows gathered into [C, cap, ...] blocks (valid first,
    in row order) and their validity [C, cap]."""
    n = x.shape[0]
    m = (w > 0)[None, :] & (cls1.long()[None, :] == torch.arange(1, num_classes + 1,
                                                                 device=x.device)[:, None])
    slot = torch.arange(cap, device=x.device)
    idx = valid_first(m)[:, slot.clamp(max=n - 1)]
    return x[idx], y[idx], slot[None, :] < m.sum(-1, keepdim=True).clamp(max=cap)


def _gram_stats_grouped(x, y, cls1, w, num_classes: int):
    """Per-class statistics from a shared row buffer, one masked pass per
    class (x [N, d], y [N, 4], cls1 [N] 1-based, w [N])."""
    return _masked_stats(x, y, [w * (cls1.long() == c + 1) for c in range(num_classes)])


def _device_solve_from_stats(g, b, sum_y, yty, n, lam: float):
    """Whitening and ridge solves on the device, batched over classes, in
    fp32 -> (beta, t, t_inv, mu, exists, mean_losses)."""
    exists = n >= 1.0
    safe_n = n.clamp(min=1.0)
    mu = torch.where(exists[:, None], sum_y / safe_n[:, None], torch.zeros_like(sum_y))
    s_c = yty - n[:, None, None] * (mu[:, :, None] * mu[:, None, :])
    s = s_c / safe_n[:, None, None]
    dvals, wvecs = torch.linalg.eigh(0.5 * (s + s.mT))
    dvals = dvals.clamp(min=0.0)
    eye4 = torch.eye(4, device=g.device).expand_as(s)
    t_dev = (wvecs * (1.0 / torch.sqrt(dvals + 0.001))[:, None, :]) @ wvecs.mT
    t_inv_dev = (wvecs * torch.sqrt(dvals + 0.001)[:, None, :]) @ wvecs.mT
    t_dev = torch.where(exists[:, None, None], t_dev, eye4)
    t_inv_dev = torch.where(exists[:, None, None], t_inv_dev, eye4)

    dp1 = g.shape[1]
    bw = (b - g[:, :, -1:] * mu[:, None, :]) @ t_dev
    eye = torch.eye(dp1, device=g.device)
    a = g + lam * eye
    dvec = torch.sqrt(torch.diagonal(a, dim1=1, dim2=2).clamp(min=1e-30))
    a_eq = a / (dvec[:, :, None] * dvec[:, None, :])
    rhs = bw / dvec[:, :, None]

    def solve_at(eps):
        am = a_eq + eps[:, None, None] * eye
        low = cholesky_or_nan(am)
        z0 = torch.cholesky_solve(rhs, low)
        # one step of iterative refinement against the factored matrix
        return z0 + torch.cholesky_solve(rhs - am @ z0, low)

    def pick(za, zb):
        ok = torch.isfinite(za).all(2).all(1)
        return torch.where(ok[:, None, None], za, zb)

    # the last level, a Gershgorin lower bound on the equilibrated
    # eigenvalues, is positive definite however far rounding pushed the Gram
    zeros = torch.zeros(g.shape[0], device=g.device)
    row_abs = a_eq.abs().sum(2) - 1.0
    eps_pd = (row_abs.amax(1) - 1.0).clamp(min=0.0) + 1e-3
    z = pick(solve_at(zeros), pick(solve_at(zeros + 3e-5),
                                   pick(solve_at(zeros + 3e-3), solve_at(eps_pd))))
    beta = z / dvec[:, :, None]
    q1 = torch.einsum("cdk,cde,cek->ck", beta, g, beta)
    q2 = (beta * bw).sum(1)
    ywty_diag = torch.einsum("ckm,ckl,clm->cm", t_dev, s_c, t_dev)
    mean_losses = 0.5 * (q1 - 2.0 * q2 + ywty_diag) / safe_n[:, None]
    mean_losses = torch.where(exists[:, None], mean_losses, torch.zeros_like(mean_losses))
    return beta, t_dev, t_inv_dev, mu, exists, mean_losses


def _masked_stats(x, y, wc):
    """Per-class statistics from the shared rows x [N, d], y [N, 4] under
    per-class weights wc [K, N] (the one-hot labels times the validity), one
    masked pass per class."""
    stats = [_gram_stats(x[None], y[None], w[None]) for w in wc]
    return tuple(torch.cat([s[k] for s in stats]) for k in range(5))


def _rls_fit_sharded(x, y, cls1, w, num_classes: int, lam: float, mesh) -> RLSModel:
    """Class-sharded Grams and solves (``device_solve`` on a mesh): the class
    axis padded to a mesh multiple, each device its slice, the models
    gathered on the mesh's first device. The classes' rows are compacted
    into blocks when the blocks are shorter than the row buffer (each row
    then enters one class's Gram); otherwise each device masks the whole
    buffer, replicated, for each of its classes. The statistics are the
    unsharded ones either way."""
    cp = -(-num_classes // mesh.size) * mesh.size
    cap = int(_class_counts(cls1, w, num_classes).max())
    n = x.shape[0]
    solved = None
    if cap > 0:
        capb = min(n, max(256, 1 << (cap - 1).bit_length()))
        if cp * capb * (x.shape[1] + 4) * 4 <= _BLOCK_BYTES_LIMIT and capb < n:
            blocks = _compact_class_blocks(x, y, cls1, w, cp, capb)
            solved = mesh.map(lambda *b: _device_solve_from_stats(*_gram_stats(*b), lam),
                              blocks)
    if solved is None:
        onehot = cls1.long()[None, :] == torch.arange(1, cp + 1, device=x.device)[:, None]
        wc = onehot.float() * w.float()[None, :]  # [Cp, N]; padded classes zero
        solved = mesh.map(lambda wk, xk, yk: _device_solve_from_stats(
            *_masked_stats(xk, yk, wk), lam), (wc,), (x, y))
    beta, t, t_inv, mu, exists, mean_losses = (v[:num_classes] for v in solved)
    return RLSModel(beta, t_inv, t, mu, exists, mean_losses)


def rls_fit_grouped(x: torch.Tensor, y: torch.Tensor, cls1: torch.Tensor, w: torch.Tensor,
                    num_classes: int, lam: float, device_solve: bool = False,
                    mesh=None) -> RLSModel:
    """All refiners from a shared row buffer: x [N, d], y [N, 4], cls1 [N]
    1-based labels, w [N] validity.

    ``device_solve``: solve on the device in fp32 (what the device pipeline
    runs) instead of on the host in float64. The device route first gathers
    each class's rows into blocks, so each row enters one class's Gram
    instead of being masked into all of them; it reads the largest class
    count to size them (one host read), and takes the masked pass where
    the blocks would not pay. The statistics are the same either way.
    ``mesh`` (with ``device_solve``): the Grams and the solves run
    class-sharded over the mesh's devices."""
    if mesh is not None and device_solve:
        return _rls_fit_sharded(x, y, cls1, w, num_classes, lam, mesh)
    if not device_solve:
        return _solve_from_stats(*_gram_stats_grouped(x, y, cls1, w, num_classes), lam)
    stats = None
    cap = int(_class_counts(cls1, w, num_classes).max())
    if cap > 0:
        capb = min(x.shape[0], max(256, 1 << (cap - 1).bit_length()))
        blk_bytes = num_classes * capb * (x.shape[1] + 4) * 4
        if blk_bytes <= _BLOCK_BYTES_LIMIT and num_classes * capb < 4 * x.shape[0]:
            stats = _gram_stats(*_compact_class_blocks(x, y, cls1, w, num_classes, capb))
    if stats is None:
        stats = _gram_stats_grouped(x, y, cls1, w, num_classes)
    beta, t, t_inv, mu, exists, mean_losses = _device_solve_from_stats(*stats, lam)
    return RLSModel(beta, t_inv, t, mu, exists, mean_losses)
