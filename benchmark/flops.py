"""The benchmark's frozen yardstick of work: operations and bytes from shapes.

The trunk's counts are copied from the program's ``utils/flops.py``
and frozen here; the training's counts (the minibootstrap's FALKON fits and
mining passes, RLS) and the kernels' operations and bytes are the
benchmark's own, worked out from the configuration's shapes as
``train_online_modules_device`` and ``harvest_dataset_device`` lay them out.
Each part is counted at the precision the configuration states for it:
the conv trunk bf16, kernel B1 3xTF32 (a third of the TF32 rate, the price
of fp32 accuracy on the tensor cores), the solvers IEEE fp32.

Peaks: NVIDIA H100 SXM data sheet, dense.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_3XTF32 = PEAK_TF32 / 3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

_STAGES = (("res2", 3, 64, 256, 64), ("res3", 4, 128, 512, 256), ("res4", 6, 256, 1024, 512))


def conv_flops(cin, cout, k, h_out, w_out) -> float:
    return 2.0 * cin * cout * k * k * h_out * w_out


def _bottleneck(cin, mid, cout, h, w, downsample) -> float:
    f = conv_flops(cin, mid, 1, h, w) + conv_flops(mid, mid, 3, h, w)
    f += conv_flops(mid, cout, 1, h, w)
    return f + (conv_flops(cin, cout, 1, h, w) if downsample else 0.0)


def backbone_c4(h: int, w: int) -> float:
    f = conv_flops(3, 64, 7, h // 2, w // 2)
    sh, sw = h // 4, w // 4
    for name, blocks, mid, cout, cin in _STAGES:
        if name != "res2":
            sh, sw = sh // 2, sw // 2
        f += _bottleneck(cin, mid, cout, sh, sw, True)
        f += (blocks - 1) * _bottleneck(cout, mid, cout, sh, sw, False)
    return f


def rpn_conv(h16: int, w16: int) -> float:
    return conv_flops(1024, 1024, 3, h16, w16)


def rpn_pretrained_heads(h16: int, w16: int, anchors: int = 15) -> float:
    return conv_flops(1024, 5 * anchors, 1, h16, w16)


def res5(n_rois: int) -> float:
    per = _bottleneck(1024, 512, 2048, 7, 7, True) + 2 * _bottleneck(2048, 512, 2048, 7, 7, False)
    return per * n_rois


def mask_deconv(n_rois: int) -> float:
    return 2.0 * 2048 * 256 * 2 * 2 * 7 * 7 * n_rois


def b1_call(groups: int, rows: int, centers: int, d: int) -> Tuple[float, float]:
    """One Gaussian-mmv call (G groups of ``rows`` rows against ``centers``
    centers each): (operations, bytes). Operations: the cross term and the
    product with v, 2 (d + 1) a row and center; bytes: x, the centers, v and
    the output once."""
    ops = 2.0 * groups * rows * centers * (d + 1)
    nbytes = 4.0 * (groups * rows * d + groups * centers * d + groups * centers + groups * rows)
    return ops, nbytes


def b1_split(sets: int, centers: int, d: int) -> Tuple[float, float]:
    """B1's operand split of its center sets (hi, lo, norms)."""
    n = sets * centers * d
    return 5.0 * n, 12.0 * n + 4.0 * sets * centers


def least_s(ops: float, nbytes: float, peak: float) -> float:
    return max(ops / peak, nbytes / PEAK_BYTES)


def b1_least_s(calls: List[Tuple[int, ...]]) -> float:
    """Least time of a list of B1 calls (groups, rows, centers, d[, center
    sets]), each with its split of the center sets (one a group unless
    given): the mmv at the 3xTF32 rate, the split by its bytes."""
    t = 0.0
    for g, n, m, d, *sets in calls:
        t += least_s(*b1_call(g, n, m, d), PEAK_3XTF32)
        t += least_s(*b1_split(sets[0] if sets else g, m, d), PEAK_FP32)
    return t


def roi_bytes(batch: int, h16: int, w16: int, rois: int, c: int = 1024, pooled: int = 14) -> float:
    """A RoIAlign call in bf16 (B3, B4): the C4 map read once, the pooled
    rows written once, the boxes read."""
    return 2.0 * batch * h16 * w16 * c + 2.0 * batch * rois * pooled * pooled * c + 16.0 * batch * rois


# ---------------------------------------------------------------- shapes

def reservoir_shapes(cfg: Dict, images: int, batch: int, gt_cap: int = 20) -> Dict[str, int]:
    """Row capacities (usable + scratch) of the pools the device harvest
    makes for ``images`` teaching images at canvas batch ``batch``."""
    neg_cap = cfg["batch_size"] * cfg["iterations"]
    npick = math.ceil(neg_cap / max(images, 1))
    return {"neg": neg_cap + npick * batch, "rpn_pos": cfg["rpn_pos_cap"] + 64 * batch,
            "det_pos": cfg["det_pos_cap"] + gt_cap * batch,
            "mask_pos": cfg["segm_pos_cap"] + gt_cap * batch * 64,
            "mask_neg": 2 * cfg["segm_batch_size"] + gt_cap * batch * 64}


def heads(cfg: Dict, images: int, batch: int) -> List[Dict]:
    """Each minibootstrap head's shapes: classes, positive slots P, iterations
    I, batch B, centers M, width d."""
    s = reservoir_shapes(cfg, images, batch)
    out = []
    if cfg["with_rpn"]:
        out.append(dict(c=cfg["num_anchor_classes"], p=s["rpn_pos"], i=cfg["iterations"],
                        b=cfg["batch_size"], m=cfg["rpn_m"], d=1024))
    out.append(dict(c=cfg["num_classes"], p=s["det_pos"], i=cfg["iterations"],
                    b=cfg["batch_size"], m=cfg["det_m"], d=2048))
    if cfg["with_segmentation"]:
        out.append(dict(c=cfg["num_classes"], p=s["mask_pos"],
                        i=max(1, math.ceil(s["mask_neg"] / cfg["segm_batch_size"])),
                        b=cfg["segm_batch_size"], m=cfg["segm_m"], d=256))
    return out


def training_work(cfg: Dict, images: int, batch: int, coxy_rows: int, rpn_pos_rows: int):
    """(B1 calls, fp32 operations) of one ``train_online_modules_device``.
    Each class window of ``solver_class_chunk`` classes (the last slides back
    to end at the last class) runs I updates: a FALKON fit on the cache's
    live prefix, then one mining pass over the next (j + 2) B negatives.
    RLS: one Gram over each head's valid rows and one solve a class."""
    calls, fp32 = [], 0.0
    for h in heads(cfg, images, batch):
        chunk = min(cfg["solver_class_chunk"] or h["c"], h["c"])
        windows = -(-h["c"] // chunk)
        m, d = h["m"], h["d"]
        for j in range(h["i"]):
            live = h["p"] + (j + 1) * h["b"]
            upto = min((j + 2) * h["b"], h["i"] * h["b"])
            per_class = (2.0 * m * m * d + 2.0 * live * m * d + 4.0 * live * m * m
                         + 7.0 * m ** 3)
            fp32 += windows * chunk * per_class
            calls += [(chunk, upto, m, d)] * windows
    refiners = [(coxy_rows, 2048, cfg["num_classes"])]
    if cfg["with_rpn"]:
        refiners.append((rpn_pos_rows, 1024, cfg["num_anchor_classes"]))
    for rows, d, classes in refiners:
        fp32 += 2.0 * rows * (d + 1) ** 2 + classes * (2.0 / 3.0) * (d + 1) ** 3
    return calls, fp32


def harvest_image_bf16(h: int, w: int, props: int = 300, gt_cap: int = 20,
                       with_mask: bool = True) -> float:
    """The harvest's bf16 convolutions for one canvas: trunk, RPN conv and
    pretrained 1x1 heads, res5 over GT ++ proposal rows, and, for the
    segmenter, res5 again and the mask deconv over the GT rows."""
    h16, w16 = h // 16, w // 16
    f = backbone_c4(h, w) + rpn_conv(h16, w16) + rpn_pretrained_heads(h16, w16)
    f += res5(props + gt_cap)
    if with_mask:
        f += res5(gt_cap) + mask_deconv(gt_cap)
    return f


def least_time(bf16: float, calls, fp32: float) -> float:
    """The least time of a mix at each part's peak, bytes ignored but B1's."""
    return bf16 / PEAK_BF16 + b1_least_s(calls) + fp32 / PEAK_FP32
