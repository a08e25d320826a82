"""Minibootstrap: streaming hard-negative mining for the FALKON classifiers
(counterpart of ``solvers/minibootstrap.py``).

Per class, over I negative batches of size B:

- batch 0 seeds the cache with all positives and the first negative batch;
- batch j > 0: the current model scores it, and its hard negatives (score
  > ``hard_thresh``) join the cache;
- FALKON is refitted on the cache (fresh Nystrom centers, at most M/2 of
  them positives);
- easy negatives (score < ``easy_thresh``) leave the cache.

The cache is a fixed buffer, [positives | negative block 0 | ... | block
I-1], with validity masks. The loop is the JAX package's production form
(``_train_one_class_unrolled``): iteration j fits on the prefix
``[: P + (j+1) B]`` and one scoring pass over ``[: (j+2) B]`` negatives both
prunes the current members and mines the next block. It runs batched over
the classes of a chunk; that pass is one grouped launch of the Gaussian-mmv
kernel (B1) for the whole chunk, one group per class.

``fit_fn`` / ``score_fn`` / ``init_fn`` are injectable: the tests drive the
same loop with a stub classifier and compare its cache membership with the
JAX package's iteration by iteration.

Draws: each class's Nystrom-center uniforms, [C, I, 2, M], are drawn once,
up front, in absolute class order (``center_uniforms``); a chunk or a mesh
shard slices its classes' rows. So neither ``class_chunk`` nor a mesh
changes what a class learns, as the JAX package's per-class keys
(``fold_in(key, i)``) guarantee there.

With ``mesh`` (``parallel/mesh.py``) the class axis is padded to a mesh
multiple, each device trains its slice of every chunk with ``train_chunk``
(one grouped B1 launch per device and iteration), and the models are
gathered on the mesh's first device; padded classes come back with
``exists`` False and are dropped.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from online_detection_tpu_torch.ops.gaussian_mmv import mmv_grouped
from online_detection_tpu_torch.parallel.mesh import pad_axis
from online_detection_tpu_torch.solvers.falkon import (
    FalkonModel,
    falkon_fit,
    select_nystrom_centers,
)
from online_detection_tpu_torch.utils.draws import uniform
from online_detection_tpu_torch.utils.stats import FeatureStats, zscore


class MinibootstrapParams(NamedTuple):
    """Solver hyperparameters (FALKON and the mining thresholds)."""

    m: int = 1000
    sigma: float = 15.0
    lam: float = 1e-5
    hard_thresh: float = -0.7
    easy_thresh: float = -0.9


def center_uniforms(c: int, n_iter: int, m: int, generator=None, device=None) -> torch.Tensor:
    """Every class's Nystrom-center uniforms, [C, I, 2, M] (positive and
    negative draws for each of the I model updates), in class order."""
    return uniform((c, n_iter, 2, m), generator, device)


def _falkon_fit_fn(j, cache_x, y, cache_is_pos, cache_valid, params, uniforms):
    """Production model update for a chunk: Nystrom centers from the update's
    uniforms [C, 2, M], then FALKON. cache_x [C, N, d], cache_valid [C, N] ->
    (alpha [C, M], centers [C, M, d])."""
    c_idx = select_nystrom_centers(cache_is_pos, cache_valid, params.m, uniforms=uniforms)
    centers = cache_x.gather(1, c_idx[..., None].expand(*c_idx.shape, cache_x.shape[-1]))
    return falkon_fit(cache_x, y, cache_valid, centers, params.sigma, params.lam), centers


def _falkon_score_fn(model, x, params):
    """Mining scores of a chunk, x [C, N, d] -> [C, N]: one B1 launch."""
    alpha, centers = model
    return mmv_grouped(x.contiguous(), centers, alpha, params.sigma)


def _falkon_init_fn(c, p_cap, d, params, device):
    return (torch.zeros((c, params.m), device=device),
            torch.zeros((c, params.m, d), device=device))


def train_chunk(pos: torch.Tensor, pos_valid: torch.Tensor, neg: torch.Tensor,
                neg_valid: torch.Tensor, params: MinibootstrapParams,
                stats: Optional[FeatureStats] = None, uniforms=None, fit_fn=_falkon_fit_fn,
                score_fn=_falkon_score_fn, init_fn=_falkon_init_fn):
    """The mining loop for C classes at once. pos [C, P, d], pos_valid [C, P],
    neg [C, I, B, d], neg_valid [C, I, B]; ``uniforms`` [C, I, 2, M], the
    classes' center uniforms (``center_uniforms``; None draws from torch's
    default generator). With ``stats`` the rows are z-scored here, into the
    one cache buffer: no second normalized copy of the pools is kept.
    Returns (model, exists [C], (cache_valid [C, I, P+I*B], neg_mask [C, I,
    I*B]))."""
    c, p_cap, d = pos.shape
    n_iter, batch = neg.shape[1], neg.shape[2]
    n_neg = n_iter * batch
    dev = pos.device
    cache_x = torch.empty((c, p_cap + n_neg, d), device=dev)
    cache_x[:, :p_cap] = pos
    cache_x[:, p_cap:] = neg.reshape(c, n_neg, d)
    cache_valid0 = torch.cat([pos_valid, neg_valid.reshape(c, n_neg)], dim=1)
    if stats is not None:
        cache_x.copy_(zscore(cache_x, stats))
        cache_x.mul_(cache_valid0[..., None])
    neg_flat = cache_x[:, p_cap:]
    cache_is_pos = torch.arange(p_cap + n_neg, device=dev) < p_cap
    y = torch.where(cache_is_pos, 1.0, -1.0)

    model = init_fn(c, p_cap, d, params, dev)
    neg_mask = torch.zeros((c, 0), dtype=torch.bool, device=dev)
    block_scores = None  # block j scored under model j-1, by the previous pass
    cache_trace, neg_trace = [], []
    pad = torch.zeros((c, n_neg), dtype=torch.bool, device=dev)
    for j in range(n_iter):
        if j == 0:  # no model yet: every valid row of the first block goes in
            hard = neg_valid[:, 0]
        else:
            hard = neg_valid[:, j] & (block_scores > params.hard_thresh)
        neg_mask = torch.cat([neg_mask, hard], dim=1)
        live = p_cap + (j + 1) * batch
        cache_valid = torch.cat([pos_valid, neg_mask], dim=1)
        model = fit_fn(j, cache_x[:, :live], y[:live], cache_is_pos[:live], cache_valid,
                       params, None if uniforms is None else uniforms[:, j])
        cache_trace.append(torch.cat([cache_valid, pad[:, (j + 1) * batch:]], dim=1))
        upto = min((j + 2) * batch, n_neg)
        scores = score_fn(model, neg_flat[:, :upto], params)
        neg_mask = neg_mask & (scores[:, :(j + 1) * batch] >= params.easy_thresh)
        block_scores = scores[:, (j + 1) * batch:upto]
        neg_trace.append(torch.cat([neg_mask, pad[:, (j + 1) * batch:]], dim=1))
    exists = pos_valid.any(1) & neg_valid.reshape(c, -1).any(1)
    return model, exists, (torch.stack(cache_trace, 1), torch.stack(neg_trace, 1))


def minibootstrap_trace(pos, pos_valid, neg, neg_valid, params: MinibootstrapParams,
                        fit_fn=_falkon_fit_fn, score_fn=_falkon_score_fn,
                        init_fn=_falkon_init_fn, generator=None):
    """The production loop with its per-iteration cache trace:
    ``(model, exists, (cache_valid [C, I, P+I*B], neg_mask [C, I, I*B]))``;
    ``cache_valid[c, j]`` is what class c trains on at update j."""
    u = center_uniforms(pos.shape[0], neg.shape[1], params.m, generator, pos.device)
    return train_chunk(pos, pos_valid, neg, neg_valid, params, None, u, fit_fn, score_fn,
                       init_fn)


def _train_window(pos, pos_valid, neg, neg_valid, uniforms, params, stats, mesh):
    """One chunk of classes: ``train_chunk`` on the caller's device, or on
    each mesh device's slice of the classes (a multiple of the mesh size),
    gathered on the mesh's first device -> (centers, alpha, exists)."""
    if mesh is None:
        (alpha, centers), exists, _ = train_chunk(pos, pos_valid, neg, neg_valid, params,
                                                  stats, uniforms)
        return centers, alpha, exists

    def shard(pos, pos_valid, neg, neg_valid, uniforms, stats):
        (alpha, centers), exists, _ = train_chunk(pos, pos_valid, neg, neg_valid, params,
                                                  stats, uniforms)
        return centers, alpha, exists

    return mesh.map(shard, (pos, pos_valid, neg, neg_valid, uniforms), (stats,))


def train_classifiers_minibootstrap(pos: torch.Tensor, pos_valid: torch.Tensor,
                                    neg: torch.Tensor, neg_valid: torch.Tensor,
                                    params: MinibootstrapParams,
                                    stats: Optional[FeatureStats] = None,
                                    class_chunk: Optional[int] = None,
                                    generator=None, mesh=None,
                                    uniforms: Optional[torch.Tensor] = None) -> FalkonModel:
    """Train all C classifiers, ``class_chunk`` classes at a time (all at
    once when None): the solver's temporaries (the cache, K_NM, Z) grow with
    the chunk. Returns a class-batched ``FalkonModel`` (on the mesh's first
    device with ``mesh``).

    ``uniforms`` [C, I, 2, M]: the classes' center uniforms; when None they
    are drawn from ``generator`` here, for all C classes at once. ``mesh``:
    the class axis (and ``class_chunk``) is padded up to a mesh multiple and
    each chunk is split over the mesh's devices."""
    c, n_iter = pos.shape[0], neg.shape[1]
    if uniforms is None:
        uniforms = center_uniforms(c, n_iter, params.m, generator, pos.device)
    if mesh is not None:
        if class_chunk is not None and class_chunk > 0:
            class_chunk = -(-class_chunk // mesh.size) * mesh.size
        step = class_chunk if class_chunk else mesh.size
        pos, pos_valid, neg, neg_valid, uniforms = (
            pad_axis(t, step) for t in (pos, pos_valid, neg, neg_valid, uniforms))
    cp = pos.shape[0]
    chunk = cp if not class_chunk or class_chunk <= 0 else class_chunk
    parts = []
    for lo in range(0, cp, chunk):
        sl = slice(lo, lo + chunk)
        parts.append(_train_window(pos[sl], pos_valid[sl], neg[sl], neg_valid[sl],
                                   uniforms[sl], params, stats, mesh))
    centers, alpha, exists = (torch.cat([p[k] for p in parts])[:c] for k in range(3))
    return FalkonModel(centers, alpha, exists, params.sigma)
