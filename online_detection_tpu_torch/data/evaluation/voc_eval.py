"""PASCAL-VOC-style detection + segmentation evaluation (a copy of the JAX
package's ``data/evaluation/voc_eval.py``; NumPy, host side).

Clean-room rebuild of ``evaluation/icubworld/icw_eval.py:151-518`` /
``evaluation/ycbv/ycbv_eval.py`` (chainercv-derived):

- detection prec/rec: per class, predictions sorted by score; greedy match to
  the argmax-IoU GT at ``iou_thresh``; difficult GTs ignore their matches;
  double-matched GTs count as false positives. **Quirk preserved**: the
  reference adds +1 to x2/y2 ("integer boxes") and THEN evaluates IoU with
  the +1-convention boxlist_iou — effective width = x2-x1+2. Bitwise parity
  demands we do the same.
- AP: VOC07 11-point metric (default) or continuous area-under-PR.
- mAP = nanmean over the class axis (unseen classes are NaN, excluded).
- segmentation: per-detection 14x14 mask probabilities are pasted into the
  image by the Masker recipe (padding=1, bilinear resize to the expanded box,
  threshold 0.5 — maskrcnn_benchmark ``Masker``), then matched by mask IoU.
  Difficult flags are NOT consulted for masks (reference behavior).

All host-side NumPy, operating on plain dict predictions:
``{"boxes": [D,4], "scores": [D], "labels": [D], "masks": [D,14,14] | None}``
in *original image* coordinates.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np


def _iou_plus1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4]x[K,4] IoU with the +1 convention (boxlist_iou)."""
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def mask_iou(mask_a: np.ndarray, mask_b: np.ndarray) -> np.ndarray:
    """[N,H,W]x[K,H,W] boolean mask IoU (``py_od_utils.mask_iou:297-331``),
    vectorized instead of the reference's double loop."""
    a = mask_a.reshape(len(mask_a), -1).astype(bool)
    b = mask_b.reshape(len(mask_b), -1).astype(bool)
    inter = a.astype(np.int64) @ b.T.astype(np.int64)
    union = a.sum(1)[:, None] + b.sum(1)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0).astype(np.float32)


def paste_mask(mask: np.ndarray, box: np.ndarray, im_h: int, im_w: int,
               thresh: float = 0.5, padding: int = 1) -> np.ndarray:
    """maskrcnn_benchmark Masker paste: expand by ``padding``, bilinear-resize
    to the (expanded, +1-convention) box size, threshold, paste."""
    m = mask.shape[0]
    padded = np.zeros((m + 2 * padding, m + 2 * padding), np.float32)
    padded[padding:-padding, padding:-padding] = mask
    scale = (m + 2.0 * padding) / m
    w_half = (box[2] - box[0]) * 0.5 * scale
    h_half = (box[3] - box[1]) * 0.5 * scale
    x_c = (box[2] + box[0]) * 0.5
    y_c = (box[3] + box[1]) * 0.5
    box_exp = np.array(
        [x_c - w_half, y_c - h_half, x_c + w_half, y_c + h_half]
    )
    box_i = box_exp.astype(np.int32)
    w = max(int(box_i[2] - box_i[0] + 1), 1)
    h = max(int(box_i[3] - box_i[1] + 1), 1)

    # bilinear resize padded -> (h, w) with torch align_corners=False semantics
    ph, pw = padded.shape
    ys = np.clip((np.arange(h) + 0.5) * ph / h - 0.5, 0, ph - 1)
    xs = np.clip((np.arange(w) + 0.5) * pw / w - 0.5, 0, pw - 1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, ph - 1)
    x1 = np.minimum(x0 + 1, pw - 1)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    resized = (
        padded[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
        + padded[np.ix_(y0, x1)] * (1 - fy) * fx
        + padded[np.ix_(y1, x0)] * fy * (1 - fx)
        + padded[np.ix_(y1, x1)] * fy * fx
    )
    binar = resized > thresh

    out = np.zeros((im_h, im_w), np.uint8)
    x_0 = max(box_i[0], 0)
    x_1 = min(box_i[2] + 1, im_w)
    y_0 = max(box_i[1], 0)
    y_1 = min(box_i[3] + 1, im_h)
    if x_1 > x_0 and y_1 > y_0:
        out[y_0:y_1, x_0:x_1] = binar[
            (y_0 - box_i[1]) : (y_1 - box_i[1]), (x_0 - box_i[0]) : (x_1 - box_i[0])
        ]
    return out


def _accumulate_prec_rec(n_pos, score, match):
    n_fg = max(n_pos.keys(), default=0) + 1
    prec: List[Optional[np.ndarray]] = [None] * n_fg
    rec: List[Optional[np.ndarray]] = [None] * n_fg
    for l in n_pos:
        s = np.asarray(score[l])
        m = np.asarray(match[l], np.int8)
        order = s.argsort()[::-1]
        m = m[order]
        tp = np.cumsum(m == 1)
        fp = np.cumsum(m == 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            prec[l] = tp / (fp + tp)
        if n_pos[l] > 0:
            rec[l] = tp / n_pos[l]
    return prec, rec


def detection_prec_rec(
    predictions: Sequence[Dict], ground_truths: Sequence[Dict], iou_thresh: float
):
    """predictions/gts: per-image dicts (see module docstring; gts have
    ``difficult``)."""
    n_pos = defaultdict(int)
    score = defaultdict(list)
    match = defaultdict(list)
    for gt, pred in zip(ground_truths, predictions):
        labels_all = np.unique(
            np.concatenate([pred["labels"], gt["labels"]]).astype(int)
        )
        for l in labels_all:
            pm = pred["labels"] == l
            pb = pred["boxes"][pm]
            ps = pred["scores"][pm]
            order = ps.argsort()[::-1]
            pb, ps = pb[order], ps[order]
            gm = gt["labels"] == l
            gb = gt["boxes"][gm]
            gd = gt["difficult"][gm]
            n_pos[l] += int(np.logical_not(gd).sum())
            score[l].extend(ps)
            if len(pb) == 0:
                continue
            if len(gb) == 0:
                match[l].extend([0] * len(pb))
                continue
            pb = pb.copy()
            pb[:, 2:] += 1  # reference's "integer boxes" shift
            gb = gb.copy()
            gb[:, 2:] += 1
            iou = _iou_plus1(pb, gb)
            gt_index = iou.argmax(axis=1)
            gt_index[iou.max(axis=1) < iou_thresh] = -1
            selec = np.zeros(len(gb), bool)
            for gi in gt_index:
                if gi >= 0:
                    if gd[gi]:
                        match[l].append(-1)
                    elif not selec[gi]:
                        match[l].append(1)
                    else:
                        match[l].append(0)
                    selec[gi] = True
                else:
                    match[l].append(0)
    return _accumulate_prec_rec(n_pos, score, match)


def segmentation_prec_rec(
    predictions: Sequence[Dict], ground_truths: Sequence[Dict], iou_thresh: float
):
    """Mask-level prec/rec; predictions carry 14x14 probabilities that get
    pasted; gts carry full-res binary ``masks`` [G, H, W]."""
    n_pos = defaultdict(int)
    score = defaultdict(list)
    match = defaultdict(list)
    for gt, pred in zip(ground_truths, predictions):
        im_h, im_w = gt["masks"].shape[1:] if len(gt["masks"]) else (0, 0)
        gt_masks = np.rint(gt["masks"]).astype(np.uint8)
        if pred.get("masks") is not None and len(pred["masks"]):
            pred_masks = np.stack(
                [
                    paste_mask(m, b, im_h, im_w)
                    for m, b in zip(pred["masks"], pred["boxes"])
                ]
            )
        else:
            pred_masks = np.zeros((0, im_h, im_w), np.uint8)
        labels_all = np.unique(
            np.concatenate([pred["labels"], gt["labels"]]).astype(int)
        )
        for l in labels_all:
            pm = pred["labels"] == l
            pmk = pred_masks[pm] if len(pred_masks) else pred_masks
            ps = pred["scores"][pm]
            order = ps.argsort()[::-1]
            pmk, ps = pmk[order], ps[order]
            gm = gt["labels"] == l
            gmk = gt_masks[gm]
            n_pos[l] += int(gm.sum())
            score[l].extend(ps)
            if len(pmk) == 0:
                continue
            if len(gmk) == 0:
                match[l].extend([0] * len(pmk))
                continue
            iou = mask_iou(pmk, gmk)
            gt_index = iou.argmax(axis=1)
            gt_index[iou.max(axis=1) < iou_thresh] = -1
            selec = np.zeros(len(gmk), bool)
            for gi in gt_index:
                if gi >= 0:
                    match[l].append(1 if not selec[gi] else 0)
                    selec[gi] = True
                else:
                    match[l].append(0)
    return _accumulate_prec_rec(n_pos, score, match)


def voc_ap(prec, rec, use_07_metric: bool = True) -> np.ndarray:
    """Per-class AP (``calc_detection_icw_ap:346-404``)."""
    n_fg = len(prec)
    ap = np.empty(n_fg)
    for l in range(n_fg):
        if prec[l] is None or rec[l] is None:
            ap[l] = np.nan
            continue
        if use_07_metric:
            a = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                if np.sum(rec[l] >= t) == 0:
                    p = 0.0
                else:
                    p = np.max(np.nan_to_num(prec[l])[rec[l] >= t])
                a += p / 11
            ap[l] = a
        else:
            mpre = np.concatenate(([0], np.nan_to_num(prec[l]), [0]))
            mrec = np.concatenate(([0], rec[l], [1]))
            mpre = np.maximum.accumulate(mpre[::-1])[::-1]
            i = np.where(mrec[1:] != mrec[:-1])[0]
            ap[l] = np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])
    return ap


def evaluate(
    predictions: Sequence[Dict],
    ground_truths: Sequence[Dict],
    class_names: Sequence[str],
    iou_thresholds: Sequence[float] = (0.5,),
    use_07_metric: bool = True,
    evaluate_segmentation: bool = False,
    output_dir: Optional[str] = None,
) -> Dict:
    """Full evaluation, appending the reference's result.txt blocks
    (``do_icw_evaluation:150-225`` format) when ``output_dir`` is given."""
    import os

    results = {}
    for iou_thresh in iou_thresholds:
        prec, rec = detection_prec_rec(predictions, ground_truths, iou_thresh)
        ap = voc_ap(prec, rec, use_07_metric)
        results[f"det_ap_{iou_thresh}"] = ap
        results[f"det_map_{iou_thresh}"] = float(np.nanmean(ap))

        block = "Detection mAP{}: {:.4f}\n\n".format(
            int(iou_thresh * 100), results[f"det_map_{iou_thresh}"]
        )
        for i in range(1, len(ap)):
            name = class_names[i] if i < len(class_names) else str(i)
            block += "{:<26}: {:.4f}\n".format(name, ap[i])
        block += "\n"
        if output_dir:
            with open(os.path.join(output_dir, "result.txt"), "a") as fid:
                fid.write(block)

        if evaluate_segmentation:
            sprec, srec = segmentation_prec_rec(
                predictions, ground_truths, iou_thresh
            )
            sap = voc_ap(sprec, srec, use_07_metric)
            results[f"segm_ap_{iou_thresh}"] = sap
            results[f"segm_map_{iou_thresh}"] = float(np.nanmean(sap))
            block = "Segmentation mAP{}: {:.4f}\n\n".format(
                int(iou_thresh * 100), results[f"segm_map_{iou_thresh}"]
            )
            for i in range(1, len(sap)):
                name = class_names[i] if i < len(class_names) else str(i)
                block += "{:<26}: {:.4f}\n".format(name, sap[i])
            block += "\n"
            if output_dir:
                with open(os.path.join(output_dir, "result.txt"), "a") as fid:
                    fid.write(block)
    return results
