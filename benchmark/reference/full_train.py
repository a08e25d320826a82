"""Plain PyTorch SGD step of Mask R-CNN R-50-C4, in IEEE fp32: the
benchmark's frozen reference for the ``full_train`` kind.

One image a step, as ``config_full_train_ycbv.yaml`` (hsp-iit/online-detection)
trains the network with maskrcnn-benchmark: the R-50-C4 trunk
(``forward.py``'s stem, bottlenecks and res5, run here on float32 tensors),
the RPN's 3x3 conv and 1x1 heads over 15 anchors a cell, RoIAlign 14x14 on
C4 (``forward.py``'s interpolation matrices), res5 and its spatial mean, the
box predictor, and the mask head (2x2/2 deconvolution, ReLU, 1x1 logits).
The losses are maskrcnn-benchmark's (``modeling/rpn/loss.py``,
``roi_heads/box_head/loss.py``, ``roi_heads/mask_head/loss.py``):

- RPN: anchors matched to the GT at IoU >= 0.7 (foreground) and < 0.3
  (background), each GT's best anchors rescued as foreground, anchors that
  cross the image's border ignored; 256 sampled at half positives; BCE
  objectness over the sampled anchors and smooth-L1 (beta 1/9) of the
  positives' deltas, both over the number sampled.
- Box head: softmax cross-entropy over the sampled RoIs and smooth-L1
  (beta 1) of each positive's own class deltas, with the (10, 10, 5, 5)
  box coder, over the number sampled.
- Mask head: BCE of each positive's own class channel against its GT mask
  projected onto the RoI (14 x 14, thresholded at 0.5), averaged over the
  positives' pixels.

The three sums the program computes are the comparison's terms:
``rpn_loss`` (objectness + box), ``box_head_loss`` (classification +
regression) and ``mask_head_loss``. Gradients come from autograd over these
plain operations, for every tensor the step trains. The update is the
program's optimizer written out: the gradients clipped to a global norm of
35 (no epsilon), weight decay added, momentum carried from the previous
step (``buf = momentum * buf + d``; ``buf = d`` on a tensor's first step),
``theta - lr * buf``, at the warm-up multi-step learning rate of the step's
iteration (``WarmupMultiStepLR``, linear warm-up).

Departures from the published description:

- The proposals and the sampled RoIs are the program's, taken as given (as
  the ``teach`` kind's check takes the harvest's proposals): with random
  weights objectness is flat, so rounding reorders the NMS and the sample.
- The samplers' uniforms are the program's ``draws=`` (maskrcnn-benchmark
  draws ``randperm``): a pool's members are ranked by their priority
  ``u - 2`` in float32, ties by index, and the first ones kept.
- The step trains what the program trains: every tensor, the frozen BN
  affines, the stem and res2 included (maskrcnn-benchmark keeps the affines
  as buffers and freezes the stem and res2, ``FREEZE_CONV_BODY_AT`` 2), with
  one learning rate and weight decay for all (maskrcnn-benchmark gives biases
  ``BIAS_LR_FACTOR`` 2 and ``WEIGHT_DECAY_BIAS`` 0), and the clip at 35,
  which maskrcnn-benchmark does not have.
- The mask head runs on the positives only, as maskrcnn-benchmark's does
  (the program runs it on every sampled RoI; the loss is the same).
- The GT mask's projection is the port's bilinear one (each of the 14 x 14
  bins sampled at its centre), where maskrcnn-benchmark crops and resizes a
  polygon or a binary mask.

It imports nothing of the program. Weights are a flat dict of tensors named
``stem.w``, ``res2.0.a.w`` (``a``, ``b``, ``c`` the bottleneck's convs,
``branch1`` its projection; ``w``, ``scale``, ``bias``), ``rpn.conv_w``,
``mask.w``, ``mask.logits_w``, ``box.cls_w`` and so on. TF32 is off
(``precision``); the control turns it on.
"""

from __future__ import annotations

import contextlib
import math
import re
from bisect import bisect_right
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import forward as fwd

CLIP_NORM = 35.0
TERMS = ("rpn_loss", "box_head_loss", "mask_head_loss")


@contextlib.contextmanager
def precision(tf32: bool = False):
    """IEEE fp32 products (both TF32 flags False), or TF32 for the control."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ---------------------------------------------------------------- weights

def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """Flat named tensors -> ``forward.py``'s nested layout (with each
    bottleneck's stride: 2 on the first block of res3, res4 and res5), plus
    ``rpn``, ``mask`` and ``box`` dicts."""
    def conv(prefix):
        return {k: flat[f"{prefix}.{k}"] for k in ("w", "scale", "bias")}

    w = {"stem": conv("stem")}
    for stage in ("res2", "res3", "res4", "res5"):
        n = 1 + max(int(m.group(1)) for k in flat
                    for m in [re.match(rf"{stage}\.(\d+)\.", k)] if m)
        w[stage] = [{"a": conv(f"{stage}.{i}.a"), "b": conv(f"{stage}.{i}.b"),
                     "c": conv(f"{stage}.{i}.c"),
                     "branch1": conv(f"{stage}.{i}.branch1") if i == 0 else None,
                     "stride": 2 if (i == 0 and stage != "res2") else 1} for i in range(n)]
    for head in ("rpn", "mask", "box"):
        w[head] = {k.split(".", 1)[1]: v for k, v in flat.items() if k.startswith(head + ".")}
    return w


# ---------------------------------------------------------------- anchors and boxes

def anchors(h16: int, w16: int, stride: int = 16, sizes=(32, 64, 128, 256, 512),
            ratios=(0.5, 1.0, 2.0)) -> torch.Tensor:
    """Detectron's anchors, [h16 * w16 * 15, 4] (cells row-major, the 15
    anchors of a cell ratio-major), xyxy with the +1 convention."""
    ctr = 0.5 * (stride - 1)
    cell = []
    for r in ratios:
        ws = np.round(np.sqrt(stride * stride / r))
        hs = np.round(ws * r)
        for s in sizes:
            aw, ah = ws * s / stride, hs * s / stride
            cell.append([ctr - 0.5 * (aw - 1), ctr - 0.5 * (ah - 1),
                         ctr + 0.5 * (aw - 1), ctr + 0.5 * (ah - 1)])
    cell = torch.tensor(np.asarray(cell, np.float64).astype(np.float32))
    ys, xs = torch.meshgrid(torch.arange(h16, dtype=torch.float32) * stride,
                            torch.arange(w16, dtype=torch.float32) * stride, indexing="ij")
    shift = torch.stack([xs, ys, xs, ys], -1).reshape(-1, 1, 4)
    return (shift + cell[None]).reshape(-1, 4)


def encode(gt: torch.Tensor, boxes: torch.Tensor, weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """maskrcnn-benchmark's ``BoxCoder.encode`` (+1 widths)."""
    wx, wy, ww, wh = weights
    bw, bh = boxes[:, 2] - boxes[:, 0] + 1, boxes[:, 3] - boxes[:, 1] + 1
    gw, gh = gt[:, 2] - gt[:, 0] + 1, gt[:, 3] - gt[:, 1] + 1
    bx, by = boxes[:, 0] + 0.5 * bw, boxes[:, 1] + 0.5 * bh
    gx, gy = gt[:, 0] + 0.5 * gw, gt[:, 1] + 0.5 * gh
    return torch.stack([wx * (gx - bx) / bw, wy * (gy - by) / bh,
                        ww * torch.log(gw / bw), wh * torch.log(gh / bh)], dim=1)


def rank_pick(u: torch.Tensor, member: torch.Tensor, n: int) -> torch.Tensor:
    """The ``n`` members of lowest priority ``u - 2`` (float32; ties by
    index) -> a mask."""
    idx = member.nonzero()[:, 0]
    order = torch.sort(u[idx] - 2.0, stable=True).indices
    out = torch.zeros_like(member)
    out[idx[order[:n]]] = True
    return out


def rpn_labels(gt: torch.Tensor, anc: torch.Tensor, image_size, u_pos, u_neg,
               batch: int = 256, pos_fraction: float = 0.5):
    """The RPN's sampled anchors: (positive mask, negative mask, each
    anchor's matched GT)."""
    iou = fwd.box_iou(gt, anc)  # [G, N]
    best = iou.amax(dim=0)
    rows = torch.arange(gt.shape[0], device=gt.device)[:, None]
    matched = torch.where(iou == best, rows, gt.shape[0]).amin(dim=0)  # the first best GT
    fg = best >= 0.7
    bg = best < 0.3
    per_gt = iou.max(dim=1, keepdim=True).values
    fg = fg | ((iou == per_gt) & (per_gt > 0)).any(dim=0)
    bg = bg & ~fg
    w, h = float(image_size[0]), float(image_size[1])
    inside = (anc[:, 0] >= 0) & (anc[:, 1] >= 0) & (anc[:, 2] < w) & (anc[:, 3] < h)
    fg, bg = fg & inside, bg & inside
    n_pos = min(int(fg.sum()), int(batch * pos_fraction))
    n_neg = min(int(bg.sum()), batch - n_pos)
    return rank_pick(u_pos, fg, n_pos), rank_pick(u_neg, bg, n_neg), matched


def roi_sample(gt: torch.Tensor, gt_labels: torch.Tensor, boxes: torch.Tensor,
               valid: torch.Tensor, u_pos, u_neg, batch: int = 512, pos_fraction: float = 0.25):
    """The box head's sample of the proposals ``boxes`` (the GT appended):
    matched at IoU 0.5, ``batch`` at a quarter positives -> (the sampled
    rows in order, their labels, which are positive)."""
    iou = torch.where(valid[None], fwd.box_iou(gt, boxes), torch.full((), -1.0,
                                                                       device=gt.device))
    best = iou.amax(dim=0)
    rows = torch.arange(gt.shape[0], device=gt.device)[:, None]
    matched = torch.where(iou == best, rows, gt.shape[0]).amin(dim=0)
    fg, bg = valid & (best >= 0.5), valid & (best < 0.5)
    n_pos = min(int(fg.sum()), int(batch * pos_fraction))
    n_neg = min(int(bg.sum()), batch - n_pos)
    pos = rank_pick(u_pos, fg, n_pos)
    idx = (pos | rank_pick(u_neg, bg, n_neg)).nonzero()[:, 0]
    labels = torch.where(pos[idx], gt_labels[matched[idx]].long(), 0)
    return idx, labels, pos[idx]


def project_masks(masks: torch.Tensor, boxes: torch.Tensor, matched: torch.Tensor,
                  out: int = 14) -> torch.Tensor:
    """Each box's GT mask (canvas-sized) sampled bilinearly at the centres of
    an out x out grid over the box, rows then columns -> [P, out, out]."""
    h, w = masks.shape[-2:]

    def weights(start, stop, dim):  # [P, out, dim]
        size = (stop - start + 1.0).clamp(min=1.0)
        k = torch.arange(out, dtype=torch.float32, device=boxes.device)
        pos = (start[:, None] + (k + 0.5) / out * size[:, None] - 0.5).clamp(0.0, dim - 1.0)
        low = torch.floor(pos)
        frac = (pos - low)[..., None]
        grid = torch.arange(dim, dtype=torch.float32, device=boxes.device)
        return (grid == low[..., None]) * (1.0 - frac) + (grid == low[..., None] + 1.0) * frac

    wy = weights(boxes[:, 1], boxes[:, 3], h)
    wx = weights(boxes[:, 0], boxes[:, 2], w)
    got = torch.zeros((boxes.shape[0], out, out), device=boxes.device)
    for g in matched.unique().tolist():
        sel = matched == g
        got[sel] = (wy[sel] @ masks[g]) @ wx[sel].transpose(1, 2)
    return got


# ---------------------------------------------------------------- the step

def losses(w: Dict, step: Dict, with_mask: bool = True):
    """The three loss terms of one image -> (terms, the RPN's positive and
    negative anchor masks). ``step``: ``image`` [H, W, 3] (the normalised
    canvas), ``image_size`` (w, h), ``gt_boxes``, ``gt_labels``,
    ``gt_valid``, ``gt_masks`` [G, H, W], ``uniforms`` (RPN positives,
    negatives, RoI positives, negatives), and the sampled RoIs
    ``roi_boxes``, ``roi_labels``, ``roi_matched``, ``roi_valid``,
    ``roi_pos``."""
    conf = fwd.CONFIGURED  # float32 tensors: every product in float32
    g = int(step["gt_valid"].sum())
    gt = step["gt_boxes"][:g].float()

    x = fwd.stem(step["image"][None].float(), w["stem"], conf).permute(0, 3, 1, 2)
    for name in ("res2", "res3", "res4"):
        x = fwd.stage(x, w[name], conf)
    c4 = x.permute(0, 2, 3, 1)  # [1, h16, w16, C]

    r = w["rpn"]
    t = torch.relu(F.conv2d(x, r["conv_w"], r["conv_b"], padding=1))
    logits = F.conv2d(t, r["cls_w"].t()[:, :, None, None], r["cls_b"])
    deltas = F.conv2d(t, r["bbox_w"].t()[:, :, None, None], r["bbox_b"])
    logits = logits.permute(0, 2, 3, 1).reshape(-1)
    deltas = deltas.permute(0, 2, 3, 1).reshape(-1, 4)
    anc = anchors(c4.shape[1], c4.shape[2]).to(gt.device)
    u = step["uniforms"]
    pos, neg, matched = rpn_labels(gt, anc, step["image_size"], u[0], u[1])
    sampled = pos | neg
    n = max(int(sampled.sum()), 1)
    objectness = F.binary_cross_entropy_with_logits(
        logits[sampled], pos[sampled].float(), reduction="sum") / n
    box = F.smooth_l1_loss(deltas[pos], encode(gt[matched[pos]], anc[pos]), beta=1.0 / 9,
                           reduction="sum") / n
    terms = {"rpn_loss": objectness + box}

    rois = step["roi_boxes"].float()
    valid, is_pos = step["roi_valid"].bool(), step["roi_pos"].bool()
    labels, roi_gt = step["roi_labels"].long(), step["roi_matched"].long()
    pooled = fwd.roi_align(c4, rois[None])[0]  # [S, 14, 14, C]
    m5 = fwd.res5_map(w, pooled, conf)  # [S, 7, 7, C5]
    feats = m5.mean(dim=(1, 2))
    b = w["box"]
    cls = F.linear(feats, b["cls_w"].t(), b["cls_b"])
    reg = F.linear(feats, b["bbox_w"].t(), b["bbox_b"]).reshape(feats.shape[0], -1, 4)
    ns = max(int(valid.sum()), 1)
    ce = F.cross_entropy(cls[valid], labels[valid], reduction="sum") / ns
    sel = reg[is_pos, labels[is_pos]]
    target = encode(step["gt_boxes"].float()[roi_gt[is_pos]], rois[is_pos], (10.0, 10.0, 5.0, 5.0))
    terms["box_head_loss"] = ce + F.smooth_l1_loss(sel, target, beta=1.0, reduction="sum") / ns

    if with_mask:
        mk = w["mask"]
        d = torch.relu(F.conv_transpose2d(m5[is_pos].permute(0, 3, 1, 2), mk["w"], mk["b"],
                                          stride=2))
        mlog = F.conv2d(d, mk["logits_w"].t()[:, :, None, None], mk["logits_b"])
        own = mlog[torch.arange(mlog.shape[0], device=mlog.device), labels[is_pos]]
        proj = project_masks(step["gt_masks"].float(), rois[is_pos], roi_gt[is_pos])
        terms["mask_head_loss"] = F.binary_cross_entropy_with_logits(
            own, (proj >= 0.5).float(), reduction="mean")
    return terms, pos, neg


def learning_rate(solver: Dict, iteration: int) -> float:
    """``WarmupMultiStepLR`` (linear warm-up) at ``iteration``, in float64."""
    factor = 1.0
    if iteration < solver["warmup_iters"]:
        alpha = iteration / solver["warmup_iters"]
        factor = solver["warmup_factor"] * (1 - alpha) + alpha
    return solver["base_lr"] * factor * solver["gamma"] ** bisect_right(list(solver["steps"]),
                                                                       iteration)


def sgd_step(flat: Dict[str, torch.Tensor], momentum: Dict[str, Optional[torch.Tensor]],
             step: Dict, iteration: int, solver: Dict, with_mask: bool = True,
             tf32: bool = False) -> Dict:
    """One SGD step from ``flat`` (the trained tensors, by name) with the
    momentum buffers ``momentum`` (None where a tensor has none yet) at
    ``iteration`` -> ``terms`` (the three losses, floats), ``grads`` (each
    tensor's gradient before the clip), ``params`` (each tensor after the
    update), ``rpn_pos`` / ``rpn_neg`` (the sampled anchors) and ``lr``.
    ``solver``: ``base_lr``, ``momentum``, ``weight_decay``,
    ``warmup_iters``, ``warmup_factor``, ``steps``, ``gamma``."""
    names = list(flat)
    with precision(tf32), torch.enable_grad():
        leaves = {k: v.detach().float().clone().requires_grad_(True) for k, v in flat.items()}
        terms, pos, neg = losses(nest(leaves), step, with_mask)
        total = sum(terms.values())
        grads = torch.autograd.grad(total, [leaves[k] for k in names], allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if gr is None else gr.detach()
             for k, gr in zip(names, grads)}
    norm = math.sqrt(sum(float((gr.double() ** 2).sum()) for gr in grads.values()))
    scale = 1.0 if norm < CLIP_NORM else CLIP_NORM / norm
    lr = learning_rate(solver, iteration)
    after = {}
    for k in names:
        theta = flat[k].detach().float()
        d = grads[k] * scale + solver["weight_decay"] * theta
        buf = d if momentum.get(k) is None else solver["momentum"] * momentum[k].float() + d
        after[k] = theta - lr * buf
    return {"terms": {k: float(v.detach()) for k, v in terms.items()}, "grads": grads,
            "params": after, "rpn_pos": pos, "rpn_neg": neg, "lr": lr}
