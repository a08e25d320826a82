"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (``benchmark/reference``).

Teaching cells, the window's last round:

- ``feat_gap``: the harvested GT-row features of a sample of images (trunk,
  B2, B4, res5) against the reference's, computed on the same canvas batch:
  the largest ||program - reference|| / ||reference|| over the sample.
- ``neg_gap``: the detector's negative pools. The reference works out from
  the boxes each canvas batch's sampling ran on (the program's proposals,
  taken as given, and the GT boxes) which rows every class may take as
  negatives (IoU with each of its GT boxes under ``NEG_IOU``), how many
  each image gives (``npick`` or all it has) and where they land in the
  pool. For a sample of batches drawn from the seed, each pool row that
  lands there is held against the reference's features of the rows the
  class may take from that image: the largest, over those pool rows, of
  the relative distance to the nearest of them.
- ``neg_count_off``: the classes whose pool holds another number of rows
  than the reference works out (an exact count).
- ``head_off``: the fitted FALKON heads (RPN, detector, segmenter) against
  the reference's training from the same pools and the same draws, on
  probe rows drawn from the pools: the number of classes, over every head,
  whose largest score gap is over ``HEAD_TOL``. A mining pass whose score
  lies within rounding of a threshold sends a row the other way, and that
  class's model then differs as a whole; every other class reads 0.
- ``rls_gap``: the RLS refiners (RPN, detector) on rows of their own
  training set: per class ||program - reference|| over its rows, divided by
  the reference's spread about the class's mean target there,
  ||reference - mean||, or by the median class's spread where that is
  larger (a class of one row, or of one target, has none); the largest over
  the classes. A refiner left at zero predicts the mean and reads 1.

A reading that cannot be taken (a class that exists on one side only, a
non-finite number) reads infinity.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import forward as ref
from benchmark.reference import train as ref_train

INF = float("inf")
# the detector harvest's rule: a negative's IoU with each GT box of its
# class is under this
NEG_IOU = 0.3
# a class's FALKON model counts as departed when its largest score gap on
# its probe rows is over this; rounding alone moves no class that far
HEAD_TOL = 1e-3


def _finite_max(vals, default=0.0) -> float:
    vals = [float(v) for v in vals]
    if any(not math.isfinite(v) for v in vals):
        return INF
    return max(vals, default=default)


def _f64(t):
    return t.double() if torch.is_floating_point(t) else t


def _canvases(teach_set, idx: List[int], canvas_hw) -> np.ndarray:
    imgs = np.zeros((len(idx),) + tuple(canvas_hw) + (3,), np.uint8)
    for k, i in enumerate(idx):
        im = teach_set.load_image(i)
        imgs[k, :im.shape[0], :im.shape[1]] = im
    return imgs


# ---------------------------------------------------------------- models

def _own_scores(model: Dict, rows: torch.Tensor, c: int) -> torch.Tensor:
    f = model["falkon"]
    z = (rows.double() - _f64(model["stats"]["mean"])) * (20.0 / _f64(model["stats"]["mean_norm"]))
    return ref.gaussian_kernel(z, _f64(f["centers"][c]), f["sigma"]) @ _f64(f["alpha"][c])


def probes(pools: Dict, cfg: Dict, rng: np.random.Generator, k: int) -> Dict:
    """Per head and class, up to ``k`` positive and ``k`` negative rows of
    the pools (the FALKON heads), and up to ``k`` rows of each refiner's own
    training set (``rpn_rls``: the RPN's positives; ``det_rls``: the
    detector's COXY rows), drawn from the seed."""
    def pick(rows, counts, c):
        n = int(counts[c])
        if n == 0:
            return rows[c, :0]
        idx = torch.from_numpy(rng.integers(0, n, size=min(k, n))).to(rows.device)
        return rows[c, idx]

    out = {}
    for head, pos, neg in (("rpn", "rpn_pos", "rpn_neg"), ("detector", "det_pos", "det_neg"),
                           ("mask", "mask_pos", "mask_neg")):
        if pools.get(pos) is None or pools.get(neg) is None:
            continue
        (pr, pc), (nr, nc) = pools[pos], pools[neg]
        out[head] = [torch.cat([pick(pr, pc, c), pick(nr, nc, c)]) for c in range(pr.shape[0])]
        if head == "rpn":
            out["rpn_rls"] = [pick(pr, pc, c) for c in range(pr.shape[0])]
    packed, counts = pools["det_coxy"]
    rows = packed[0, :int(counts[0])]
    d = rows.shape[1] - 5
    sel = [rows[rows[:, d + 4].long() == c + 1, :d] for c in range(cfg["num_classes"])]
    out["det_rls"] = [s[torch.from_numpy(rng.integers(0, len(s), size=min(k, len(s)))).to(
        s.device)] if len(s) else s for s in sel]
    return out


def _rls_rows(head: str, model: Dict, x: torch.Tensor) -> torch.Tensor:
    """The rows a refiner sees: the RPN's are z-scored by its own stats."""
    if head != "rpn":
        return x
    return (x - _f64(model["stats"]["mean"])) * (20.0 / _f64(model["stats"]["mean_norm"]))


def _rls_deltas(head: str, p: Dict, r: Dict, rows_of: List[torch.Tensor]):
    """(class, the program's deltas, the reference's) on each class's rows."""
    pp = {k: _f64(v) for k, v in p["rls"].items()}
    rr = {k: _f64(v) for k, v in r["rls"].items()}
    for c, rows in enumerate(rows_of):
        if len(rows) and bool(r["rls"]["exists"][c]):
            x = rows.double()
            yield (c, ref.rls_predict(pp, _rls_rows(head, p, x))[:, c],
                   ref.rls_predict(rr, _rls_rows(head, r, x))[:, c])


def models_gap(prog: Dict, refm: Dict, pr: Dict) -> Dict[str, float]:
    """``head_off`` and ``rls_gap`` of the program's models against the
    reference's, and beside them (not compared) ``head_gap_max``, the number
    of classes over 1e-6 and 1e-2 (``head_off_1e-6``, ``head_off_1e-2``),
    each refiner's ``rls_gap`` by itself, and ``rls_gap_max_norm``: the
    largest |delta gap| over the largest |delta|, on the refiner's own rows
    and on the rows an earlier definition took (the RPN's FALKON probe rows,
    negatives included: rows outside its training set)."""
    bad = {"head_off": INF, "head_gap_max": INF, "rls_gap": INF}
    gaps = []
    for head in ("rpn", "detector", "mask"):
        if head not in pr or refm.get(head) is None:
            continue
        if prog.get(head) is None:
            return bad
        pf, rf = prog[head]["falkon"], refm[head]["falkon"]
        if not torch.equal(pf["exists"].cpu(), rf["exists"].cpu()):
            return bad
        for c, rows in enumerate(pr[head]):
            if len(rows) and bool(rf["exists"][c]):
                gaps.append(float((_own_scores(prog[head], rows, c)
                                   - _own_scores(refm[head], rows, c)).abs().max()))
    out = {"head_gap_max": _finite_max(gaps)}
    for name, tol in (("head_off", HEAD_TOL), ("head_off_1e-6", 1e-6), ("head_off_1e-2", 1e-2)):
        out[name] = float(sum(1 for g in gaps if not g <= tol))
    rls = []
    for head, own, old in (("rpn", "rpn_rls", "rpn"), ("detector", "det_rls", "det_rls")):
        if refm.get(head) is None or pr.get(own) is None:
            continue
        p, r = prog[head], refm[head]
        if not torch.equal(p["rls"]["exists"].cpu(), r["rls"]["exists"].cpu()):
            return bad
        gaps_c, spreads = [], []
        for c, dp, dr in _rls_deltas(head, p, r, pr[own]):
            gaps_c.append(float((dp - dr).norm()))
            spreads.append(float((dr - _f64(r["rls"]["mu"][c])).norm()))
        floor = float(np.median(spreads)) if spreads else 0.0
        per = [g / max(sp, floor) if max(sp, floor) > 0 else (0.0 if g == 0 else INF)
               for g, sp in zip(gaps_c, spreads)]
        out[f"rls_gap.{head}"] = _finite_max(per)
        rls.append(out[f"rls_gap.{head}"])
        for name, rows_of in (("own", pr[own]), ("probes", pr[old])):
            pairs = list(_rls_deltas(head, p, r, rows_of))
            den = max((float(dr.abs().max()) for _, _, dr in pairs), default=0.0)
            if den > 0:
                num = max(float((dp - dr).abs().max()) for _, dp, dr in pairs)
                out[f"rls_gap_max_norm.{head}.{name}"] = num / den
    out["rls_gap"] = _finite_max(rls)
    return out


def reference_models(state_or_pools, cfg: Dict, train_seed: int, device,
                     prec: ref.Precision = ref.CONFIGURED) -> Dict:
    pools = state_or_pools if isinstance(state_or_pools, dict) else \
        ref_train.pools_of(state_or_pools)
    gen = torch.Generator(device=device).manual_seed(train_seed)
    return ref_train.train(pools, cfg, gen, prec)


# ---------------------------------------------------------------- teaching

def feat_gap(w: Dict, teach_set, det_pos, mix: Dict, classes: int, rng, device,
             got_fn=None) -> float:
    """The harvested GT-row features of a sample of images against the
    reference's, each image's batch recomputed whole. ``got_fn`` stands in
    for the program's rows (the control)."""
    n, b = len(teach_set), mix["batch"]
    picked = sorted(rng.choice(n, size=min(mix["check_images"], n), replace=False).tolist())
    worst = []
    for lo in sorted({i // b * b for i in picked}):
        idx = list(range(lo, min(lo + b, n)))
        gb = np.zeros((len(idx), 20, 4), np.float32)
        for k, i in enumerate(idx):
            gb[k, 0] = teach_set.get_annotation(i).boxes[0]
        imgs_t = torch.from_numpy(_canvases(teach_set, idx, mix["canvas_hw"])).to(device)
        gb_t = torch.from_numpy(gb).to(device)
        want = ref.gt_features(w, imgs_t, gb_t)[:, 0]
        got_b = None if got_fn is None else got_fn(imgs_t, gb_t)[:, 0]
        for k, i in enumerate(idx):
            if i not in picked:
                continue
            c, j = i % classes, i // classes
            if got_b is not None:
                got = got_b[k]
            elif j < int(det_pos[1][c]):
                got = det_pos[0][c, j]
            else:
                worst.append(INF)
                continue
            worst.append(float((got.double() - want[k].double()).norm()
                               / want[k].double().norm().clamp(min=1e-30)))
    return _finite_max(worst)


def neg_layout(batches: List[Dict], n_images: int, cfg: Dict) -> Dict:
    """Where the detector's negatives of a round land, worked out from the
    boxes each canvas batch's sampling ran on (``batches``: per batch the
    proposals, their validity, the image sizes and the GT boxes, labels and
    validity). Per batch: ``eligible`` [B, C, R] (GT rows first, then the
    proposals), ``start`` and ``take`` [B, C] (the first pool slot of each
    image's rows and how many it gives); and ``count`` [C], what each pool
    holds at the end."""
    c_n, cap = cfg["num_classes"], cfg["batch_size"] * cfg["iterations"]
    npick = math.ceil(cap / max(n_images, 1))
    filled = torch.zeros(c_n, dtype=torch.long)
    out = []
    lo = 0
    for bt in batches:
        size = bt["sizes"].float()
        boxes = ref.clip_two_sided(torch.cat([bt["gt_boxes"], bt["props"]], 1).float(),
                                   size[:, None, :])
        g = bt["gt_boxes"].shape[1]
        valid = torch.cat([bt["gt_valid"], bt["pvalid"]], 1)
        iou = ref.box_iou(boxes[:, :g], boxes)  # [B, G, R]
        onehot = ((bt["gt_labels"].long()[..., None] == torch.arange(1, c_n + 1, device=iou.device))
                  & bt["gt_valid"][..., None])  # [B, G, C]
        over = torch.where(onehot[..., None], iou[:, :, None, :], torch.zeros_like(
            iou[:, :, None, :])).amax(1)  # [B, C, R]
        elig = valid[:, None, :] & (over < NEG_IOU)
        real = torch.arange(elig.shape[0], device=elig.device) < n_images - lo
        take = (elig.sum(-1).clamp(max=npick) * real[:, None]).cpu()
        start = filled[None, :] + torch.cumsum(take, 0) - take
        out.append({"eligible": elig, "start": start, "take": take})
        filled = (filled + take.sum(0)).clamp(max=cap)
        lo += elig.shape[0]
    return {"batches": out, "count": filled, "cap": cap}


def pool_answers(layout: Dict, picked: List[int], rows: torch.Tensor) -> Dict:
    """The program's answers: for each picked batch, image and class, the
    pool rows the reference says its negatives land on."""
    out = {}
    for k in picked:
        lay = layout["batches"][k]
        for (i, c), s in np.ndenumerate(lay["start"].numpy()):
            e = min(int(s) + int(lay["take"][i, c]), layout["cap"])
            if e > s:
                out[(k, i, c)] = rows[c, int(s):e]
    return out


def neg_gap(w: Dict, teach_set, layout: Dict, batches: List[Dict], answers: Dict, mix: Dict,
            device) -> float:
    """The largest, over ``answers`` ((batch, image, class) -> rows), of a
    row's relative distance to the nearest of the reference's features of
    the rows its class may take from its image."""
    b, worst = mix["batch"], []
    for k in sorted({key[0] for key in answers}):
        bt, lay = batches[k], layout["batches"][k]
        idx = list(range(k * b, min(k * b + b, len(teach_set))))
        imgs = torch.from_numpy(_canvases(teach_set, idx, mix["canvas_hw"])).to(device)
        boxes = torch.cat([bt["gt_boxes"], bt["props"]], 1).float()[:len(idx)].to(device)
        with torch.inference_mode():
            c4 = ref.backbone_c4(w, imgs, ref.CONFIGURED)
            feats = torch.cat([ref.box_features(w, c4[i:i + 1], boxes[i:i + 1])
                               for i in range(len(idx))])
        for (kk, i, c), got in answers.items():
            if kk != k:
                continue
            f = feats[i][lay["eligible"][i, c].to(device)].double()
            if not len(f):
                worst.append(INF)
                continue
            dist = torch.cdist(got.double().to(device), f) / f.norm(dim=1)[None]
            worst.append(float(dist.amin(1).max()))
    return _finite_max(worst)


def neg_count_off(layout: Dict, counts: torch.Tensor) -> float:
    return float((counts.cpu().long() != layout["count"]).sum())


def teach_readings(w: Dict, teach_set, mix: Dict, cfg: Dict, pools: Dict, batches: List[Dict],
                   models: Dict, refm: Dict, rng, device,
                   answers_of: Optional[Callable] = None, got_fn=None) -> Dict[str, float]:
    """Every number of a teaching cell. ``models``: the answering side's
    fitted models; ``answers_of(layout, picked)`` its negative rows (the
    program's pool by default); ``got_fn`` its GT-row features (``feat_gap``)."""
    classes = cfg["num_classes"]
    out = {"feat_gap": feat_gap(w, teach_set, pools["det_pos"], mix, classes, rng, device,
                                got_fn)}
    layout = neg_layout(batches, len(teach_set), cfg)
    picked = sorted(rng.choice(len(batches), size=min(mix["check_neg_batches"], len(batches)),
                               replace=False).tolist())
    answers = (answers_of or (lambda lay, p: pool_answers(lay, p, pools["det_neg"][0])))(
        layout, picked)
    out["neg_gap"] = neg_gap(w, teach_set, layout, batches, answers, mix, device)
    out["neg_count_off"] = neg_count_off(layout, pools["det_neg"][1])
    out.update(models_gap(models, refm, probes(pools, cfg, rng, mix["probe_rows"])))
    return out
