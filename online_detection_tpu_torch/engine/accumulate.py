"""Host reservoirs of the host route: fold per-image harvest chunks into the
per-class training buffers the solvers take (counterpart of
``engine/accumulate.py``).

Mirrors the batch-filling half of ``rpn_getProposals.py:283-363`` /
``box_head_getProposals.py:228-291`` and ``py_od_utils.shuffle_negatives``
(``:276-294``): per-class negative pools are shuffled and split into
``ITERATIONS`` batches of ``BATCH_SIZE`` (the flagship configs run with
``SHUFFLE_NEGATIVES: True``), or dealt round-robin in arrival order;
positives and COXY are concatenated. The segmentation pools split into
20000-row batches in arrival order (``SEGMENTATION.BATCH_SIZE``).

Outputs are the fixed-capacity masked arrays ``train_classifiers_minibootstrap``
and ``rls_fit`` take: [C, I, B, d] (+valid), [C, P, d] (+valid), COXY.

``add`` brings an image's chunk to the host in one copy: its tensors are
packed into one byte buffer on their device, copied into a pinned host
buffer without blocking, and read after one sync. Everything after the copy
is the JAX package's NumPy, so with the same seed the shuffles and the
finalized arrays are the same bits.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from online_detection_tpu_torch.engine.harvest import DetChunk, HarvestChunk, MaskChunk, RPNChunk


class _ClassPools:
    """Per-class growable pools of (features, ...) rows."""

    def __init__(self, n_classes: int):
        self.n = n_classes
        self.pos: List[List[np.ndarray]] = [[] for _ in range(n_classes)]
        self.neg: List[List[np.ndarray]] = [[] for _ in range(n_classes)]

    def add_pos(self, c: int, rows: np.ndarray):
        if len(rows):
            self.pos[c].append(rows)

    def add_neg(self, c: int, rows: np.ndarray):
        if len(rows):
            self.neg[c].append(rows)

    def count(self, which: str, c: int) -> int:
        return sum(len(r) for r in getattr(self, which)[c])

    def cat(self, which: str, c: int, dim: int) -> np.ndarray:
        pool = getattr(self, which)[c]
        if not pool:
            return np.zeros((0, dim), np.float32)
        return np.concatenate(pool, axis=0)


def _pad_stack(arrays: List[np.ndarray], cap: int, dim: int):
    """[C] list of [n_c, dim] -> ([C, cap, dim], [C, cap] valid, dropped)."""
    c = len(arrays)
    out = np.zeros((c, cap, dim), np.float32)
    valid = np.zeros((c, cap), bool)
    dropped = 0
    for i, a in enumerate(arrays):
        n = min(len(a), cap)
        dropped += len(a) - n
        out[i, :n] = a[:n]
        valid[i, :n] = True
    return out, valid, dropped


def _batch_split(pool: np.ndarray, out: np.ndarray, valid: np.ndarray,
                 rng: Optional[np.random.Generator]) -> int:
    """Pool [n, dim] -> the zeroed batches ``out`` [I, B, dim] and ``valid``
    [I, B], in place; shuffled when rng given (``shuffle_negatives``) else
    split in arrival order. The batches fill the flat [I * B] slots in
    order, so the kept rows are gathered straight into them. Returns the
    rows dropped."""
    n = len(pool)
    slots = out.shape[0] * out.shape[1]
    keep = min(n, slots)
    flat = out.reshape(-1, out.shape[-1])
    if rng is not None and n:
        flat[:keep] = pool[rng.permutation(n)[:keep]]
    else:
        flat[:keep] = pool[:keep]
    valid.reshape(-1)[:keep] = True
    return max(0, n - slots)


def _round_robin_split(image_chunks: List[np.ndarray], out: np.ndarray, valid: np.ndarray,
                       negatives_to_pick: Optional[int] = None) -> int:
    """SHUFFLE_NEGATIVES=False semantics (``rpn_getProposals.py:290-340``,
    ``box_head_getProposals.py:245-270``): each image contributes up to
    ``ceil(negatives_to_pick / iterations)`` rows to each batch in order,
    skipping full batches, so every batch mixes rows from across the image
    stream. The per-batch stride uses the configured ``negatives_to_pick``
    (``rpn_getProposals.py:296``), not the image's own row count: they
    differ when a pool underfills, and the stride changes batch membership.
    Fills the zeroed ``out`` [I, B, dim] and ``valid`` [I, B] in place and
    returns the rows dropped."""
    iterations, batch_size = valid.shape
    fill = np.zeros((iterations,), int)
    current_batch = 0
    for rows in image_chunks:
        npick = len(rows)
        if npick == 0 or current_batch >= iterations:
            continue
        per_batch = math.ceil((negatives_to_pick or npick) / iterations)
        idx = 0
        for b in range(current_batch, iterations):
            if fill[b] >= batch_size:
                current_batch = b + 1
                continue
            take = min(per_batch, batch_size - fill[b], npick - idx)
            if take <= 0:
                break
            out[b, fill[b]: fill[b] + take] = rows[idx: idx + take]
            fill[b] += take
            idx += take
            if idx >= npick:
                break
    valid[:] = np.arange(batch_size)[None, :] < fill[:, None]
    total = sum(len(r) for r in image_chunks)
    return max(0, total - int(fill.sum()))


def _leaves(chunk: HarvestChunk):
    """(part, field) names and tensors of a chunk, None parts left out."""
    out = [(("average_recall", None), chunk.average_recall)]
    for part in ("rpn", "det", "mask"):
        sub = getattr(chunk, part)
        if sub is not None:
            out += [((part, f), getattr(sub, f)) for f in sub._fields]
    return out


class HarvestAccumulator:
    """Folds HarvestChunks; ``finalize`` produces solver-ready arrays.
    ``host_bytes`` counts what ``add`` copied to the host."""

    def __init__(
        self,
        num_anchor_classes: int,
        num_classes: int,
        rpn_dim: int = 1024,
        det_dim: int = 2048,
        mask_dim: int = 256,
        seed: int = 0,
    ):
        self.rpn_pools = _ClassPools(num_anchor_classes)
        self.det_pools = _ClassPools(num_classes)
        self.mask_pools = _ClassPools(num_classes)
        self.rpn_coxy: List[tuple] = []  # (x, y, c)
        self.det_coxy: List[tuple] = []
        self.dims = (rpn_dim, det_dim, mask_dim)
        self.rng = np.random.default_rng(seed)
        self.ar_values: List[float] = []
        # per-image chunk caps (RPN PPOS / COXY-per-image / mask PIX) drops
        self.harvest_dropped = 0
        self.host_bytes = 0
        self._staging: Optional[torch.Tensor] = None  # pinned, reused per image

    # -- the copy to the host ---------------------------------------------

    def _to_host(self, chunk: HarvestChunk) -> HarvestChunk:
        """One packed device-to-host copy of the chunk -> the same chunk of
        NumPy arrays. On the card the arrays are views of a pinned buffer
        that the next image reuses: what the pools keep must be a copy."""
        leaves = sorted(_leaves(chunk), key=lambda kv: -kv[1].element_size())  # aligned
        packed = torch.cat([t.reshape(-1).view(torch.uint8) for _, t in leaves])
        if packed.device.type == "cuda":
            if self._staging is None or self._staging.numel() < packed.numel():
                self._staging = torch.empty(packed.numel(), dtype=torch.uint8, pin_memory=True)
            host = self._staging[:packed.numel()]
            host.copy_(packed, non_blocking=True)
            torch.cuda.current_stream(packed.device).synchronize()
        else:
            host = packed
        buf = host.numpy()
        self.host_bytes += packed.numel()
        arrays, off = {}, 0
        for name, t in leaves:
            dt = np.dtype(str(t.dtype).replace("torch.", ""))
            arrays[name] = np.frombuffer(buf, dt, t.numel(), off).reshape(tuple(t.shape))
            off += t.numel() * dt.itemsize

        def part(name, cls):
            sub = getattr(chunk, name)
            return None if sub is None else cls(*(arrays[(name, f)] for f in cls._fields))

        return HarvestChunk(part("rpn", RPNChunk), part("det", DetChunk),
                            part("mask", MaskChunk), arrays[("average_recall", None)])

    # -- per-image folding ------------------------------------------------

    def add(self, chunk: HarvestChunk):
        """Folds one image's chunk (the port's ``HarvestChunk`` with no batch
        axis, on any device)."""
        chunk = self._to_host(chunk)
        if chunk.rpn is not None:
            self._add_rpn(chunk.rpn)
            self.harvest_dropped += int(np.sum(chunk.rpn.pos_dropped))
        self._add_det(chunk.det)
        self.harvest_dropped += int(chunk.det.coxy_dropped)
        if chunk.mask is not None:
            self._add_mask(chunk.mask)
            self.harvest_dropped += int(chunk.mask.dropped)
        self.ar_values.append(float(chunk.average_recall))

    def _add_rpn(self, r: RPNChunk):
        a_cls = r.neg.shape[0]
        for a in range(a_cls):
            self.rpn_pools.add_neg(a, np.asarray(r.neg[a][np.asarray(r.neg_valid[a])]))
            pv = np.asarray(r.pos_valid[a])
            pos_rows = np.asarray(r.pos[a][pv])
            self.rpn_pools.add_pos(a, pos_rows)
            if pv.any():
                y = np.asarray(r.coxy_y[a][pv])
                self.rpn_coxy.append(
                    (pos_rows, y, np.full((len(y),), a, np.float32))
                )

    def _add_det(self, d: DetChunk):
        pv = np.asarray(d.pos_valid)
        labels = np.asarray(d.pos_labels)
        feats = np.asarray(d.pos)
        for i in np.nonzero(pv)[0]:
            # a copy: ``feats`` may be a view of the reused staging buffer
            self.det_pools.add_pos(int(labels[i]) - 1, feats[i: i + 1].copy())
        n_cls = d.neg.shape[0]
        for c in range(n_cls):
            self.det_pools.add_neg(c, np.asarray(d.neg[c][np.asarray(d.neg_valid[c])]))
        cv = np.asarray(d.coxy_valid)
        if cv.any():
            self.det_coxy.append(
                (
                    np.asarray(d.coxy_x[cv]),
                    np.asarray(d.coxy_y[cv]),
                    np.asarray(d.coxy_c[cv]),
                )
            )

    def _add_mask(self, m: MaskChunk):
        lv = np.asarray(m.labels_valid)
        labels = np.asarray(m.labels)
        for i in np.nonzero(lv)[0]:
            c = int(labels[i]) - 1
            self.mask_pools.add_pos(c, np.asarray(m.pos[i][np.asarray(m.pos_valid[i])]))
            self.mask_pools.add_neg(c, np.asarray(m.neg[i][np.asarray(m.neg_valid[i])]))

    # -- assembly ---------------------------------------------------------

    def _coxy(self, entries, dim):
        if not entries:
            return {
                "X": np.zeros((0, dim), np.float32),
                "Y": np.zeros((0, 4), np.float32),
                "C": np.zeros((0,), np.float32),
            }
        return {
            "X": np.concatenate([e[0] for e in entries]),
            "Y": np.concatenate([e[1] for e in entries]),
            "C": np.concatenate([np.ravel(e[2]) for e in entries]),
        }

    def finalize_head(
        self,
        pools: _ClassPools,
        dim: int,
        iterations: int,
        batch_size: int,
        shuffle: bool = True,
        pos_cap: Optional[int] = None,
        negatives_to_pick: Optional[int] = None,
        arrival_order: bool = False,
    ) -> Dict[str, np.ndarray]:
        """-> {pos, pos_valid, neg, neg_valid} solver-shaped arrays."""
        c = pools.n
        pos_cat = [pools.cat("pos", i, dim) for i in range(c)]
        if pos_cap is None:
            pos_cap = max(1, max((len(p) for p in pos_cat), default=1))
        pos, pos_valid, pos_dropped = _pad_stack(pos_cat, pos_cap, dim)
        neg = np.zeros((c, iterations, batch_size, dim), np.float32)
        neg_valid = np.zeros((c, iterations, batch_size), bool)
        neg_dropped = 0
        for i in range(c):
            # each class's batches are written straight into the head's arrays
            if shuffle or arrival_order:
                # shuffle: flush-time randperm re-batching
                # (``extract_features_rpn_detector.py:320-346``); arrival
                # order (rng=None): the mask pools' append-and-roll-over
                # filling (``mask_head_getProposals.py:118-138``)
                neg_dropped += _batch_split(pools.cat("neg", i, dim), neg[i], neg_valid[i],
                                            self.rng if shuffle else None)
            else:
                # non-shuffle parity: per-image round-robin batch filling
                neg_dropped += _round_robin_split(pools.neg[i], neg[i], neg_valid[i],
                                                  negatives_to_pick)
        return {
            "pos": pos, "pos_valid": pos_valid,
            "neg": neg, "neg_valid": neg_valid,
            "truncated": {"pos": int(pos_dropped), "neg": int(neg_dropped)},
        }

    def finalize(
        self,
        rpn_iterations: int = 10,
        rpn_batch_size: int = 2000,
        det_iterations: int = 10,
        det_batch_size: int = 2000,
        segm_batch_size: int = 20000,
        shuffle_negatives: bool = True,
        rpn_shuffle_negatives: Optional[bool] = None,
        with_rpn: bool = True,
        with_mask: bool = True,
        negatives_to_pick: Optional[int] = None,
    ) -> Dict:
        if rpn_shuffle_negatives is None:
            rpn_shuffle_negatives = shuffle_negatives
        rpn_dim, det_dim, mask_dim = self.dims
        out: Dict = {
            "average_recall": float(np.mean(self.ar_values)) if self.ar_values else 0.0
        }
        if with_rpn:
            out["rpn"] = self.finalize_head(
                self.rpn_pools, rpn_dim, rpn_iterations, rpn_batch_size,
                rpn_shuffle_negatives, negatives_to_pick=negatives_to_pick,
            )
            out["rpn"]["coxy"] = self._coxy(self.rpn_coxy, rpn_dim)
        out["det"] = self.finalize_head(
            self.det_pools, det_dim, det_iterations, det_batch_size,
            shuffle_negatives, negatives_to_pick=negatives_to_pick,
        )
        out["det"]["coxy"] = self._coxy(self.det_coxy, det_dim)
        if with_mask:
            # segmentation: arrival-order batches of SEGMENTATION.BATCH_SIZE
            # (the pools' row counts, without concatenating them)
            counts = [max(self.mask_pools.count("neg", i), self.mask_pools.count("pos", i))
                      for i in range(self.mask_pools.n)]
            seg_iters = max(1, math.ceil(max(counts, default=1) / segm_batch_size))
            out["mask"] = self.finalize_head(
                self.mask_pools, mask_dim, seg_iters, segm_batch_size,
                shuffle=False, arrival_order=True,
            )
        # overflow accounting: fixed capacities must never truncate silently
        # (the reference keeps unbounded per-class lists,
        # ``box_head_getProposals.py:161-172``)
        trunc = {"harvest": int(self.harvest_dropped)}
        for k in ("rpn", "det", "mask"):
            if k in out:
                t = out[k].pop("truncated")
                trunc[f"{k}_pos"] = t["pos"]
                trunc[f"{k}_neg"] = t["neg"]
        trunc["total"] = sum(trunc.values())
        out["truncation"] = trunc
        return out
