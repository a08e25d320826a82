"""Plain PyTorch on-line training, the benchmark's frozen reference for the
teaching cells.

It fits the on-line RPN (FALKON + RLS), detector (RLS + FALKON) and
segmenter (FALKON) from harvested pools, as ``train_online_modules_device``
states the algorithm: z-scoring statistics from rows sampled per class, the
minibootstrap (hard-negative mining over I negative batches, FALKON refits
on a fresh Nystrom draw, easy negatives leaving the cache), and ridge
regression with whitened targets. Draws come from a ``torch.Generator`` in
the same order and shapes as the algorithm makes them, so a generator seeded
alike gives the same Nystrom centers and batches.

The reference starts from the pools the program harvested (the harvest is
checked apart: its GT rows by ``forward.gt_features``, the detector's
negative pools by ``judge.neg_gap``). It imports nothing of the program;
pools are read by field name.

Precision: IEEE fp32 throughout, as configured (FALKON's mining passes and
solves, RLS's Grams and solves). The control (``forward.CONTROL``) runs the
fp32 products in TF32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from benchmark.reference.forward import CONFIGURED, Precision, fp32_mode, gaussian_kernel

EPS_JITTER = 1e-6


def uniform(shape, gen, device):
    return torch.rand(shape, generator=gen, device=gen.device if gen is not None else device
                      ).to(device)


def randint_below(hi, n, gen, uniforms=None):
    u = uniform(hi.shape[:-1] + (n,), gen, hi.device) if uniforms is None else uniforms
    return torch.minimum((u * hi).long(), hi - 1)


def valid_first(mask):
    return torch.sort((~mask).to(torch.uint8), dim=-1, stable=True).indices


def masked_sample(mask, n_out, gen):
    """All valid rows when they are at most ``n_out``, else ``n_out`` draws
    with replacement -> (idx, valid)."""
    n = mask.shape[-1]
    cnt = mask.sum(-1, keepdim=True)
    order = valid_first(mask)
    slot = torch.arange(n_out, device=mask.device)
    first = torch.minimum(slot, (cnt - 1).clamp(min=0))
    draws = randint_below(cnt.clamp(min=1), n_out, gen)
    take = torch.where(cnt > n_out, draws, first)
    return order.gather(-1, take.clamp(0, n - 1)), slot < cnt.clamp(max=n_out)


def valid_mask(rows, counts):
    return torch.arange(rows.shape[1], device=counts.device)[None, :] < counts[:, None]


def feature_stats(pos_rows, pos_counts, neg_rows, neg_counts, gen, pos_fraction,
                  num_samples: int = 4000):
    c, _, d = pos_rows.shape
    take_pos = math.ceil((num_samples / c) * pos_fraction)
    take_neg = math.ceil((num_samples / c) * (1 - pos_fraction))

    def sample(rows, counts, take):
        idx, ok = masked_sample(valid_mask(rows, counts), take, gen)
        return rows.gather(1, idx[..., None].expand(c, take, d)), ok

    pr, pv = sample(pos_rows, pos_counts, take_pos)
    nr, nv = sample(neg_rows, neg_counts, take_neg)
    rows = torch.cat([pr.reshape(-1, d), nr.reshape(-1, d)])
    w = torch.cat([pv.reshape(-1), nv.reshape(-1)]).float()
    n = w.sum().clamp(min=1.0)
    mean = (rows * w[:, None]).sum(0) / n
    return {"mean": mean, "mean_norm": (rows.norm(dim=1) * w).sum() / n}


def zscore(x, stats):
    return (x - stats["mean"]) * (20.0 / stats["mean_norm"])


# ---------------------------------------------------------------- splits

def shuffle_split(rows, counts, iters, batch, uniforms):
    c, cap, d = rows.shape
    dev = rows.device
    take = iters * batch
    pri = uniforms + (torch.arange(cap, device=dev)[None, :] >= counts[:, None]).float() * 1e9
    order = torch.sort(pri, dim=-1, stable=True).indices
    idx = order[:, torch.arange(take, device=dev).clamp(max=cap - 1)]
    out = rows.gather(1, idx[..., None].expand(c, take, d))
    ok = torch.arange(take, device=dev)[None, :] < counts.clamp(max=take)[:, None]
    return out.reshape(c, iters, batch, d), ok.reshape(c, iters, batch)


def interleave_split(rows, counts, iters, batch):
    c, cap, d = rows.shape
    dev = rows.device
    idx = (torch.arange(batch, device=dev)[None, :] * iters
           + torch.arange(iters, device=dev)[:, None]).reshape(-1)
    out = rows[:, idx.clamp(max=cap - 1)].reshape(c, iters, batch, d)
    ok = (idx[None] < counts.clamp(max=cap)[:, None]).reshape(c, iters, batch)
    return out, ok


def arrival_split(rows, counts, iters, batch):
    c, cap, d = rows.shape
    take = torch.arange(iters * batch, device=rows.device)
    out = rows[:, take.clamp(max=cap - 1)].reshape(c, iters, batch, d)
    return out, (take[None] < counts[:, None]).reshape(c, iters, batch)


# ---------------------------------------------------------------- FALKON

def cholesky_or_nan(a):
    low, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], low, torch.full_like(low, float("nan")))


def nystrom_centers(is_pos, valid, m, uniforms):
    """[C, m] row indices: at most m // 2 positives, the rest negatives,
    each drawn with replacement when there are more than the slots."""
    n = valid.shape[-1]
    pv, nv = is_pos & valid, ~is_pos & valid
    n_pos, n_neg = pv.sum(-1, keepdim=True), nv.sum(-1, keepdim=True)
    op, on = valid_first(pv), valid_first(nv)
    half = m // 2
    n_pos_sel = n_pos.clamp(max=half)
    n_neg_sel = torch.minimum(n_neg, m - n_pos_sel)
    pu, nu = uniforms.unbind(-2)
    rand_pos = randint_below(n_pos.clamp(min=1), m, None, pu)
    rand_neg = randint_below(n_neg.clamp(min=1), m, None, nu)
    slot = torch.arange(m, device=valid.device)
    pos_take = torch.where(n_pos > half, rand_pos, torch.minimum(slot, (n_pos - 1).clamp(min=0)))
    pos_rows = op.gather(-1, pos_take.clamp(0, n - 1))
    t = slot - n_pos_sel
    neg_take = torch.where(n_neg > m - n_pos_sel, rand_neg,
                           torch.minimum(t, (n_neg - 1).clamp(min=0)))
    neg_rows = on.gather(-1, neg_take.clamp(0, n - 1))
    idx = torch.where(slot < n_pos_sel, pos_rows, neg_rows)
    total = n_pos_sel + n_neg_sel
    return torch.where(slot < total.clamp(min=1), idx, idx[..., :1])


def falkon_fit(x, y, w, centers, sigma, lam):
    """FALKON's preconditioned Nystrom solve, written out as its direct
    solution: x [C, N, d], centers [C, M, d] -> alpha [C, M]."""
    m = centers.shape[-2]
    w = w.float()
    n = w.sum(-1).clamp(min=1.0)[..., None, None]
    eye = torch.eye(m, dtype=torch.float32, device=x.device)
    t_low = cholesky_or_nan(gaussian_kernel(centers, centers, sigma) + EPS_JITTER * m * eye)
    a_low = cholesky_or_nan(t_low.mT @ t_low / m + lam * eye)
    s_mat = torch.linalg.solve_triangular(a_low.mT, eye.expand_as(a_low), upper=True)
    b_mat = torch.linalg.solve_triangular(t_low.mT, s_mat, upper=True)
    z = gaussian_kernel(x, centers, sigma) @ b_mat
    p_mat = (z * w[..., None]).mT @ z / n + lam * (s_mat.mT @ s_mat)
    p_mat = 0.5 * (p_mat + p_mat.mT)
    rhs = ((y.float() * w)[..., None, :] @ z).mT / n
    beta = torch.cholesky_solve(rhs, cholesky_or_nan(p_mat))
    return (b_mat @ beta)[..., 0]


def mining_scores(x, centers, alpha, sigma, block: int = 8192):
    """[C, N, d] rows against each class's own model -> [C, N]."""
    outs = []
    for i in range(0, x.shape[1], block):
        outs.append((gaussian_kernel(x[:, i:i + block], centers, sigma)
                     @ alpha[..., None])[..., 0])
    return torch.cat(outs, 1)


def minibootstrap(pos, pos_valid, neg, neg_valid, hp: Dict, stats, uniforms):
    """The mining loop for C classes at once -> (centers, alpha, exists)."""
    c, p_cap, d = pos.shape
    n_iter, batch = neg.shape[1], neg.shape[2]
    n_neg = n_iter * batch
    dev = pos.device
    cache = torch.empty((c, p_cap + n_neg, d), device=dev)
    cache[:, :p_cap] = pos
    cache[:, p_cap:] = neg.reshape(c, n_neg, d)
    valid0 = torch.cat([pos_valid, neg_valid.reshape(c, n_neg)], 1)
    cache.copy_(zscore(cache, stats))
    cache.mul_(valid0[..., None])
    neg_flat = cache[:, p_cap:]
    is_pos = torch.arange(p_cap + n_neg, device=dev) < p_cap
    y = torch.where(is_pos, 1.0, -1.0)
    alpha = centers = None
    neg_mask = torch.zeros((c, 0), dtype=torch.bool, device=dev)
    block_scores = None
    for j in range(n_iter):
        hard = neg_valid[:, 0] if j == 0 else neg_valid[:, j] & (block_scores > hp["hard"])
        neg_mask = torch.cat([neg_mask, hard], 1)
        live = p_cap + (j + 1) * batch
        cv = torch.cat([pos_valid, neg_mask], 1)
        idx = nystrom_centers(is_pos[:live], cv, hp["m"], uniforms[:, j])
        centers = cache[:, :live].gather(1, idx[..., None].expand(*idx.shape, d))
        alpha = falkon_fit(cache[:, :live], y[:live], cv, centers, hp["sigma"], hp["lam"])
        upto = min((j + 2) * batch, n_neg)
        scores = mining_scores(neg_flat[:, :upto], centers, alpha, hp["sigma"])
        neg_mask = neg_mask & (scores[:, :(j + 1) * batch] >= hp["easy"])
        block_scores = scores[:, (j + 1) * batch:upto]
    exists = pos_valid.any(1) & neg_valid.reshape(c, -1).any(1)
    return centers, alpha, exists


def train_head(neg_rows, neg_counts, pos, pos_valid, hp, stats, iters, batch, mode, chunk, gen):
    """A whole head, ``chunk`` classes at a time (the last window slides back
    to end at the last class); the draws are made up front in class order."""
    c = pos.shape[0]
    dev = pos.device
    chunk = min(c if not chunk or chunk <= 0 else chunk, c)
    shuffle_u = uniform((c, neg_rows.shape[1]), gen, dev) if mode == "shuffle" else None
    center_u = uniform((c, iters, 2, hp["m"]), gen, dev)
    parts = []
    lo = 0
    while lo < c:
        lo_eff = min(lo, c - chunk)
        drop = lo - lo_eff
        win = slice(lo_eff, lo_eff + chunk)
        if mode == "shuffle":
            neg, nv = shuffle_split(neg_rows[win], neg_counts[win], iters, batch, shuffle_u[win])
        elif mode == "interleave":
            neg, nv = interleave_split(neg_rows[win], neg_counts[win], iters, batch)
        else:
            neg, nv = arrival_split(neg_rows[win], neg_counts[win], iters, batch)
        ctr, alpha, ex = minibootstrap(pos[win], pos_valid[win], neg, nv, hp, stats,
                                       center_u[win])
        parts.append((ctr[drop:], alpha[drop:], ex[drop:]))
        lo = lo_eff + chunk
    return {"centers": torch.cat([p[0] for p in parts]), "alpha": torch.cat([p[1] for p in parts]),
            "exists": torch.cat([p[2] for p in parts]), "sigma": hp["sigma"]}


# ---------------------------------------------------------------- RLS

def rls_fit(x, y, cls1, w, num_classes, lam):
    """Per class: bias column, targets centred and whitened by the inverse
    square root of their covariance (eigenvalues + 0.001), then
    ``(X^T X + lam I) beta = X^T Yw``, in fp32 as configured: the Gram of
    each class's rows, Jacobi equilibration, Cholesky with jitter escalating
    over {0, 3e-5, 3e-3, a Gershgorin bound} until the factor is finite,
    one step of iterative refinement. (The control runs it with the Grams in
    TF32.)"""
    d = x.shape[1]
    dev = x.device
    gs, bs, sys_, yys, ns = [], [], [], [], []
    for k in range(num_classes):
        m = (w > 0) & (cls1.long() == k + 1)
        xk = torch.cat([x[m], torch.ones((int(m.sum()), 1), device=dev)], 1)
        yk = y[m]
        gs.append(xk.T @ xk)
        bs.append(xk.T @ yk)
        sys_.append(yk.sum(0))
        yys.append(yk.T @ yk)
        ns.append(float(xk.shape[0]))
    g, b, sum_y, yty = (torch.stack(t) for t in (gs, bs, sys_, yys))
    n = torch.tensor(ns, device=dev)
    exists = n >= 1.0
    safe_n = n.clamp(min=1.0)
    mu = torch.where(exists[:, None], sum_y / safe_n[:, None], torch.zeros_like(sum_y))
    s_c = yty - n[:, None, None] * (mu[:, :, None] * mu[:, None, :])
    ev, vec = torch.linalg.eigh(0.5 * (s_c + s_c.mT) / safe_n[:, None, None])
    ev = ev.clamp(min=0.0)
    eye4 = torch.eye(4, device=dev).expand_as(s_c)
    t = torch.where(exists[:, None, None], (vec * (1.0 / torch.sqrt(ev + 0.001))[:, None, :])
                    @ vec.mT, eye4)
    t_inv = torch.where(exists[:, None, None], (vec * torch.sqrt(ev + 0.001)[:, None, :])
                        @ vec.mT, eye4)
    bw = (b - g[:, :, -1:] * mu[:, None, :]) @ t
    eye = torch.eye(d + 1, device=dev)
    a = g + lam * eye
    dvec = torch.sqrt(torch.diagonal(a, dim1=1, dim2=2).clamp(min=1e-30))
    a_eq = a / (dvec[:, :, None] * dvec[:, None, :])
    rhs = bw / dvec[:, :, None]

    def solve_at(eps):
        am = a_eq + eps[:, None, None] * eye
        low = cholesky_or_nan(am)
        z0 = torch.cholesky_solve(rhs, low)
        return z0 + torch.cholesky_solve(rhs - am @ z0, low)

    def pick(za, zb):
        ok = torch.isfinite(za).all(2).all(1)
        return torch.where(ok[:, None, None], za, zb)

    zeros = torch.zeros(num_classes, device=dev)
    eps_pd = ((a_eq.abs().sum(2) - 1.0).amax(1) - 1.0).clamp(min=0.0) + 1e-3
    z = pick(solve_at(zeros), pick(solve_at(zeros + 3e-5),
                                   pick(solve_at(zeros + 3e-3), solve_at(eps_pd))))
    return {"beta": z / dvec[:, :, None], "t_inv": t_inv, "t": t, "mu": mu, "exists": exists}


# ---------------------------------------------------------------- the round

def pools_of(state) -> Dict:
    """The harvested pools as plain (rows, counts) pairs, read by field name."""
    out = {}
    for name in ("rpn_neg", "rpn_pos", "rpn_coxy_y", "det_neg", "det_pos", "det_coxy",
                 "mask_pos", "mask_neg"):
        p = getattr(state, name)
        out[name] = None if p is None else (p.rows, p.counts)
    return out


def train(pools: Dict, cfg: Dict, gen: Optional[torch.Generator],
          prec: Precision = CONFIGURED) -> Dict:
    """Every head from the pools -> {"rpn", "detector", "mask"} of plain
    dicts (``forward.models_of`` layout)."""
    with fp32_mode(prec), torch.inference_mode():
        def hp(m, sigma, lam):
            return {"m": m, "sigma": float(sigma), "lam": lam, "hard": cfg["hard_thresh"],
                    "easy": cfg["easy_thresh"]}

        out = {"rpn": None, "mask": None}
        pf = cfg["pos_fraction_feat_stats"]
        chunk = cfg["solver_class_chunk"]
        if cfg["with_rpn"] and pools["rpn_neg"] is not None:
            pos, pcnt = pools["rpn_pos"]
            nrows, ncnt = pools["rpn_neg"]
            pv = valid_mask(pos, pcnt)
            st = feature_stats(pos, pcnt, nrows, ncnt, gen, pf)
            f = train_head(nrows, ncnt, pos, pv, hp(cfg["rpn_m"], cfg["rpn_sigma"], cfg["rpn_lam"]),
                           st, cfg["iterations"], cfg["batch_size"],
                           "shuffle" if cfg["rpn_shuffle_negatives"] else "interleave", chunk, gen)
            a = pos.shape[0]
            cls1 = torch.arange(1, a + 1, device=pos.device)[:, None].expand_as(pv)
            rls = rls_fit(zscore(pos, st).reshape(-1, pos.shape[-1]),
                          pools["rpn_coxy_y"][0].reshape(-1, 4), cls1.reshape(-1),
                          pv.reshape(-1).float(), a, cfg["rpn_reg_lam"])
            out["rpn"] = {"falkon": f, "rls": rls, "stats": st}

        packed = pools["det_coxy"][0][0]
        cv = valid_mask(pools["det_coxy"][0], pools["det_coxy"][1])[0]
        d = packed.shape[1] - 5
        cx, cy, cc = packed[:, :d], packed[:, d:d + 4], packed[:, d + 4]
        c = cfg["num_classes"]
        if cfg["use_only_gt_positives_detection"]:
            pos, pcnt = pools["det_pos"]
            pv = valid_mask(pos, pcnt)
        else:
            m = cv[None, :] & (cc.long()[None, :] == torch.arange(1, c + 1, device=cx.device)[:, None])
            frac = cfg["sampling_ratio_positives_detection"]
            if frac < 1.0:
                r = torch.where(m, uniform(m.shape, gen, m.device), torch.full_like(
                    m, 2.0, dtype=torch.float32))
                rank = torch.sort(torch.sort(r, 1, stable=True).indices, 1, stable=True).indices
                m = m & (rank < torch.floor(m.sum(1, keepdim=True) * frac).long())
            n_out = pools["det_pos"][0].shape[1]
            slot = torch.arange(n_out, device=m.device)
            idx = valid_first(m).gather(-1, slot.clamp(max=m.shape[-1] - 1).expand(c, n_out))
            pv = slot < m.sum(-1, keepdim=True).clamp(max=n_out)
            pos, pcnt = cx[idx], pv.sum(1)
        nrows, ncnt = pools["det_neg"]
        st = feature_stats(pos, pcnt, nrows, ncnt, gen, pf)
        reg_x = zscore(cx, st) if cfg["normalize_features_regressor_detector"] else cx
        rls = rls_fit(reg_x, cy, cc, cv.float(), c, cfg["det_reg_lam"])
        f = train_head(nrows, ncnt, pos, pv, hp(cfg["det_m"], cfg["det_sigma"], cfg["det_lam"]),
                       st, cfg["iterations"], cfg["batch_size"],
                       "shuffle" if cfg["shuffle_negatives"] else "interleave", chunk, gen)
        out["detector"] = {"falkon": f, "rls": rls, "stats": st}

        if cfg["with_segmentation"] and pools["mask_pos"] is not None:
            prow, pcnt = pools["mask_pos"]
            nrows, ncnt = pools["mask_neg"]
            iters = max(1, math.ceil(nrows.shape[1] / cfg["segm_batch_size"]))
            st = feature_stats(prow, pcnt, nrows, ncnt, gen, pf)
            f = train_head(nrows, ncnt, prow, valid_mask(prow, pcnt),
                           hp(cfg["segm_m"], cfg["segm_sigma"], cfg["segm_lam"]), st, iters,
                           cfg["segm_batch_size"], "arrival", chunk, gen)
            out["mask"] = {"falkon": f, "stats": st}
        return out
