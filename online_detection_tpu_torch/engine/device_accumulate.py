"""Device-resident reservoirs for the harvest (counterpart of
``engine/device_accumulate.py``).

Fixed-capacity pools per head live on the card. A canvas batch's chunks are
compacted valid-first (stably, so rows keep their (image, slot) arrival
order) and written in one slice per pool at the running count; the invalid
tail lands in scratch rows that the next append overwrites. Appends update
the pool tensors in place. The splits turn a negative pool into the
[C, I, B, d] minibootstrap batches on the card, and the feature statistics
are computed there too: nothing but the trained models leaves the card.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from online_detection_tpu_torch.engine.harvest import (
    DetChunk,
    HarvestChunk,
    MaskChunk,
    RPNChunk,
    masked_sample,
)
from online_detection_tpu_torch.utils.draws import uniform, valid_first
from online_detection_tpu_torch.utils.stats import FeatureStats


@dataclass
class Pool:
    """rows [C, cap + scratch, d] and per-class counts [C] (int64).

    ``attempted`` counts every valid row ever offered, so ``attempted -
    counts`` is what a saturated pool dropped; None on derived pools."""

    rows: torch.Tensor
    counts: torch.Tensor
    attempted: Optional[torch.Tensor] = None

    @staticmethod
    def make(c: int, cap: int, d: int, extra: int, device=None) -> "Pool":
        """``extra`` scratch rows let a full-size append near the cap write
        without clamping into valid rows."""
        return Pool(torch.zeros((c, cap + extra, d), device=device),
                    torch.zeros((c,), dtype=torch.long, device=device),
                    torch.zeros((c,), dtype=torch.long, device=device))

    def dropped(self) -> int:
        """Rows lost to saturation, summed over classes (a host read)."""
        if self.attempted is None:
            return 0
        return int((self.attempted - self.counts).clamp(min=0).sum())

    @property
    def capacity(self) -> int:
        return self.rows.shape[1]

    def valid_mask(self, cap: Optional[int] = None) -> torch.Tensor:
        cap = cap or self.capacity
        return torch.arange(cap, device=self.counts.device)[None, :] < self.counts[:, None]


def _append(pool: Pool, chunk_rows: torch.Tensor, chunk_valid: torch.Tensor) -> Pool:
    """Masked append per class, in place: chunk_rows [C, L, d] valid-first,
    chunk_valid [C, L]."""
    cap = pool.capacity
    c, l = chunk_valid.shape
    dev = chunk_rows.device
    n_new = chunk_valid.sum(-1)
    offset = pool.counts.clamp(0, cap - l)
    pool.rows[torch.arange(c, device=dev)[:, None],
              offset[:, None] + torch.arange(l, device=dev)] = chunk_rows
    attempted = None if pool.attempted is None else pool.attempted + n_new
    return Pool(pool.rows, (pool.counts + n_new).clamp(max=cap - l), attempted)


@dataclass
class DeviceReservoirs:
    rpn_neg: Optional[Pool]
    rpn_pos: Optional[Pool]
    rpn_coxy_y: Optional[Pool]  # aligned with rpn_pos rows
    det_neg: Optional[Pool]
    det_pos: Optional[Pool]  # [C, cap, 2048] GT-row features routed by label
    det_coxy: Optional[Pool]  # one "class": [1, cap, 2048 + 4 + 1] packed (x, y, c)
    mask_pos: Optional[Pool]
    mask_neg: Optional[Pool]
    ar_sum: torch.Tensor
    n_images: torch.Tensor
    # drops at the per-image chunk caps (RPN positives, COXY, mask pixels)
    harvest_dropped: torch.Tensor

    def replace(self, **kw) -> "DeviceReservoirs":
        return dataclasses.replace(self, **kw)


def init_reservoirs(num_anchor_classes: int, num_classes: int, neg_cap: int,
                    rpn_pos_cap: int = 4096, det_pos_cap: int = 4096, coxy_cap: int = 30000,
                    mask_cap: int = 40000, mask_pos_cap: Optional[int] = None,
                    chunk_sizes: Optional[Dict[str, int]] = None, with_rpn: bool = True,
                    with_mask: bool = True, rpn_dim: int = 1024, det_dim: int = 2048,
                    mask_dim: int = 256, batch_size: int = 1, device=None) -> DeviceReservoirs:
    """Empty pools. ``batch_size`` is the canvas batch of one fold: the scratch
    margins grow with it so a whole batch's append fits; the usable
    capacities (the ``cap`` arguments) do not change."""
    cs = chunk_sizes or {}
    b = max(1, int(batch_size))
    npick = cs.get("npick", 64) * b
    ppos = cs.get("rpn_pos", 64) * b
    gcap = cs.get("gt_cap", 20) * b
    ccap = cs.get("coxy", 256) * b
    pix = cs.get("mask_pix", 64)

    def make(c, cap, d, extra, on=True):
        return Pool.make(c, cap, d, extra, device) if on else None

    zero = torch.zeros((), device=device)
    return DeviceReservoirs(
        rpn_neg=make(num_anchor_classes, neg_cap, rpn_dim, npick, with_rpn),
        rpn_pos=make(num_anchor_classes, rpn_pos_cap, rpn_dim, ppos, with_rpn),
        rpn_coxy_y=make(num_anchor_classes, rpn_pos_cap, 4, ppos, with_rpn),
        det_neg=make(num_classes, neg_cap, det_dim, npick),
        det_pos=make(num_classes, det_pos_cap, det_dim, gcap),
        det_coxy=make(1, coxy_cap, det_dim + 5, ccap),
        mask_pos=make(num_classes, mask_pos_cap or mask_cap, mask_dim, gcap * pix, with_mask),
        mask_neg=make(num_classes, mask_cap, mask_dim, gcap * pix, with_mask),
        ar_sum=zero.clone(), n_images=zero.long(), harvest_dropped=zero.long())


def _route_by_class(rows, labels, valid, num_classes: int):
    """[N, d] rows with 1-based labels -> per-class valid-first chunks
    [C, N, d] and their validity [C, N]."""
    dev = rows.device
    m = valid[None, :] & (labels.long()[None, :] == torch.arange(1, num_classes + 1,
                                                                 device=dev)[:, None])
    order = valid_first(m)
    return rows[order], torch.arange(rows.shape[0], device=dev)[None, :] < m.sum(-1,
                                                                               keepdim=True)


def _compact_batch(valid, *row_arrays):
    """Stable valid-first compaction across the canvas batch: [B, C, L, d]
    image-major -> [C, B*L, d]. One shared order per class keeps row-aligned
    arrays aligned, and keeps exactly the rows, in the order, that B
    per-image appends would."""
    b, c, l = valid.shape
    v = valid.transpose(0, 1).reshape(c, b * l)
    order = valid_first(v)
    outs = []
    for r in row_arrays:
        rr = r.transpose(0, 1).reshape(c, b * l, r.shape[-1])
        outs.append(rr.gather(1, order[..., None].expand(c, b * l, r.shape[-1])))
    return v.gather(1, order), outs


def _append_batch(pool: Pool, chunk_rows, chunk_valid) -> Pool:
    """One append per pool per canvas batch: chunk_rows [B, C, L, d]."""
    valid, (rows,) = _compact_batch(chunk_valid, chunk_rows)
    return _append(pool, rows, valid)


def accumulate_batch(state: DeviceReservoirs, chunks: HarvestChunk, img_valid: torch.Tensor,
                     num_classes: int) -> DeviceReservoirs:
    """Folds a canvas batch's chunks (leading image axis on every field) into
    the reservoirs; ``img_valid`` [B] gates the padded tail images. The same
    rows, counts and drop accounting as folding the images one by one."""
    gate2, gate3 = img_valid[:, None], img_valid[:, None, None]
    upd = {}
    if chunks.rpn is not None and state.rpn_neg is not None:
        r: RPNChunk = chunks.rpn
        upd["rpn_neg"] = _append_batch(state.rpn_neg, r.neg, r.neg_valid & gate3)
        pv, (pos_rows, coxy_rows) = _compact_batch(r.pos_valid & gate3, r.pos, r.coxy_y)
        upd["rpn_pos"] = _append(state.rpn_pos, pos_rows, pv)
        upd["rpn_coxy_y"] = _append(state.rpn_coxy_y, coxy_rows, pv)
    d: DetChunk = chunks.det
    upd["det_neg"] = _append_batch(state.det_neg, d.neg, d.neg_valid & gate3)
    b, g = d.pos.shape[:2]
    pos_rows, pos_valid = _route_by_class(d.pos.reshape(b * g, -1), d.pos_labels.reshape(-1),
                                          (d.pos_valid & gate2).reshape(-1), num_classes)
    upd["det_pos"] = _append(state.det_pos, pos_rows, pos_valid)
    packed = torch.cat([d.coxy_x, d.coxy_y, d.coxy_c[..., None]], dim=-1)  # [B, L, d+5]
    upd["det_coxy"] = _append_batch(state.det_coxy, packed[:, None],
                                    (d.coxy_valid & gate2)[:, None])
    if chunks.mask is not None and state.mask_pos is not None:
        m: MaskChunk = chunks.mask
        _, gm, pix, md = m.pos.shape
        labels = m.labels.reshape(b * gm).repeat_interleave(pix)  # image-major
        for name, rows, valid in (("mask_pos", m.pos, m.pos_valid),
                                  ("mask_neg", m.neg, m.neg_valid)):
            routed, routed_valid = _route_by_class(rows.reshape(-1, md), labels,
                                                   (valid & gate3).reshape(-1), num_classes)
            upd[name] = _append(getattr(state, name), routed, routed_valid)
    oki = img_valid.long()
    upd["ar_sum"] = state.ar_sum + (chunks.average_recall * img_valid).sum()
    upd["n_images"] = state.n_images + oki.sum()
    hd = (d.coxy_dropped * oki).sum()
    if chunks.rpn is not None and state.rpn_neg is not None:
        hd = hd + (chunks.rpn.pos_dropped.sum(1) * oki).sum()
    if chunks.mask is not None and state.mask_pos is not None:
        hd = hd + (chunks.mask.dropped * oki).sum()
    upd["harvest_dropped"] = state.harvest_dropped + hd
    return state.replace(**upd)


def accumulate(state: DeviceReservoirs, chunk: HarvestChunk, num_classes: int
               ) -> DeviceReservoirs:
    """Folds one image's chunk (no batch axis) into the reservoirs: one
    append per pool, the same rows and counts as ``accumulate_batch`` of a
    batch holding only this image."""
    upd = {}
    if chunk.rpn is not None and state.rpn_neg is not None:
        r: RPNChunk = chunk.rpn
        upd["rpn_neg"] = _append(state.rpn_neg, r.neg, r.neg_valid)
        upd["rpn_pos"] = _append(state.rpn_pos, r.pos, r.pos_valid)
        upd["rpn_coxy_y"] = _append(state.rpn_coxy_y, r.coxy_y, r.pos_valid)
    d: DetChunk = chunk.det
    upd["det_neg"] = _append(state.det_neg, d.neg, d.neg_valid)
    pos_rows, pos_valid = _route_by_class(d.pos, d.pos_labels, d.pos_valid, num_classes)
    upd["det_pos"] = _append(state.det_pos, pos_rows, pos_valid)
    packed = torch.cat([d.coxy_x, d.coxy_y, d.coxy_c[:, None]], dim=1)[None]  # [1, L, d+5]
    upd["det_coxy"] = _append(state.det_coxy, packed, d.coxy_valid[None])
    if chunk.mask is not None and state.mask_pos is not None:
        m: MaskChunk = chunk.mask
        g, pix, md = m.pos.shape
        labels = m.labels.repeat_interleave(pix)  # (gt, pixel) flattened, routed by class
        for name, rows, valid in (("mask_pos", m.pos, m.pos_valid),
                                  ("mask_neg", m.neg, m.neg_valid)):
            routed, routed_valid = _route_by_class(rows.reshape(g * pix, md), labels,
                                                   valid.reshape(-1), num_classes)
            upd[name] = _append(getattr(state, name), routed, routed_valid)
    upd["ar_sum"] = state.ar_sum + chunk.average_recall
    upd["n_images"] = state.n_images + 1
    hd = chunk.det.coxy_dropped.long()
    if chunk.rpn is not None and state.rpn_neg is not None:
        hd = hd + chunk.rpn.pos_dropped.sum()
    if chunk.mask is not None and state.mask_pos is not None:
        hd = hd + chunk.mask.dropped
    upd["harvest_dropped"] = state.harvest_dropped + hd
    return state.replace(**upd)


# --------------------------------------------------------------------------
# negative pools -> minibootstrap batches


def shuffle_split(pool: Pool, iterations: int, batch_size: int, generator=None,
                  uniforms=None):
    """Shuffled [C, I, B, d] batches + validity [C, I, B]: rows ranked by a
    uniform priority, rows past the count last. ``uniforms`` [C, cap] as
    given when not None."""
    c, cap, d = pool.rows.shape
    dev = pool.rows.device
    take = iterations * batch_size
    u = uniform((c, cap), generator, dev) if uniforms is None else \
        torch.as_tensor(uniforms, device=dev)
    pri = u + (torch.arange(cap, device=dev)[None, :] >= pool.counts[:, None]).float() * 1e9
    order = torch.sort(pri, dim=-1, stable=True).indices
    idx = order[:, torch.arange(take, device=dev).clamp(max=cap - 1)]
    rows = pool.rows.gather(1, idx[..., None].expand(c, take, d))
    valid = torch.arange(take, device=dev)[None, :] < pool.counts.clamp(max=take)[:, None]
    return rows.reshape(c, iterations, batch_size, d), valid.reshape(c, iterations, batch_size)


def interleave_split(pool: Pool, iterations: int, batch_size: int):
    """Round-robin deal of the arrival-order pool: batch b, slot s <- row
    s * I + b, so every batch mixes rows from across the image stream."""
    c, cap, d = pool.rows.shape
    dev = pool.rows.device
    idx = (torch.arange(batch_size, device=dev)[None, :] * iterations
           + torch.arange(iterations, device=dev)[:, None]).reshape(-1)
    rows = pool.rows[:, idx.clamp(max=cap - 1)].reshape(c, iterations, batch_size, d)
    valid = (idx[None] < pool.counts.clamp(max=cap)[:, None]).reshape(c, iterations, batch_size)
    return rows, valid


def arrival_split(pool: Pool, iterations: int, batch_size: int):
    """Consecutive arrival-order batches (the segmentation pools)."""
    c, cap, d = pool.rows.shape
    dev = pool.rows.device
    take = torch.arange(iterations * batch_size, device=dev)
    rows = pool.rows[:, take.clamp(max=cap - 1)].reshape(c, iterations, batch_size, d)
    valid = (take[None] < pool.counts[:, None]).reshape(c, iterations, batch_size)
    return rows, valid


def device_feature_stats_pool(pos: Pool, neg: Pool, num_samples: int = 4000,
                              pos_fraction: float = 0.8, generator=None,
                              draws=None) -> FeatureStats:
    """Z-scoring statistics from rows sampled per class out of the positive
    and negative pools (arrival order). ``draws``: (positive, negative)
    index draws, [C, take] each."""
    c, _, d = pos.rows.shape
    take_pos = math.ceil((num_samples / c) * pos_fraction)
    take_neg = math.ceil((num_samples / c) * (1 - pos_fraction))
    pd, nd = (None, None) if draws is None else draws

    def sample(pool, take, dr):
        idx, valid = masked_sample(pool.valid_mask(), take, generator=generator, draws=dr)
        return pool.rows.gather(1, idx[..., None].expand(c, take, d)), valid

    p_rows, p_valid = sample(pos, take_pos, pd)
    n_rows, n_valid = sample(neg, take_neg, nd)
    rows = torch.cat([p_rows.reshape(-1, d), n_rows.reshape(-1, d)])
    w = torch.cat([p_valid.reshape(-1), n_valid.reshape(-1)]).float()
    n = w.sum().clamp(min=1.0)
    mean = (rows * w[:, None]).sum(0) / n
    var = (((rows - mean) ** 2) * w[:, None]).sum(0) / (n - 1.0).clamp(min=1.0)
    mean_norm = (rows.norm(dim=1) * w).sum() / n
    return FeatureStats(mean, var.sqrt(), mean_norm)
