"""SGD baseline trainers: full training and fine-tuning of Mask R-CNN
(counterpart of ``engine/trainer.py``).

The comparison baselines of ``run_experiment_full_train.py`` and
``run_experiment_fine_tuning.py`` (the on-line pipeline is gradient-free):

- SGD with momentum 0.9, weight decay and a warmup multi-step LR
  (``lr_schedule``), after a global-norm clip at 35;
- output layers re-initialised by the CLIs, and freeze groups per the
  fine-tune flags (backbone / RPN except its logits / heads except the
  predictors, ``freeze_mask``);
- time-budgeted training (``--train_for_time XXh:YYm:ZZs``).

The port keeps the network's tensors as buffers of ``nn.Module``s, so
inference never builds a graph. ``do_train`` trains a deep copy on the
device: every tensor is cloned outside ``inference_mode`` and the ones the
freeze groups leave trainable get ``requires_grad``; the caller's params
are not touched, and the returned copy has ``requires_grad`` off again.
Gradients come from torch autograd, through the stem kernel B2 and the
RoIAlign kernel B3, whose backward passes live beside them
(``ops/stem_pool.py``, ``ops/roi_align.py``).

The optimizer is ``torch.optim.SGD`` (momentum, ``weight_decay``) over the
trainable tensors, after ``clip_by_global_norm``; each step's learning rate
is ``lr_schedule(cfg)`` at the step count before the step. That is the JAX
package's optax chain: mask, clip (no epsilon), add ``wd * p``, momentum
trace from zero, ``-lr * trace``. A trainable tensor the loss does not reach
gets a zero gradient, so weight decay still moves it, as under optax.

Each step runs in IEEE fp32 (``utils.device.ieee_fp32``), as the JAX
trainer is f32.

A run can go on over several calls: ``do_train(..., run=SGDRun())`` keeps in
the ``SGDRun`` what a later call continues from (the iteration, which drives
the learning rate and the image order, the trained tensors, the optimizer's
momentum buffers and the host generator of the order and the flips), as
maskrcnn-benchmark resumes a checkpoint up to ``MAX_ITER``. Two calls that
carry it compute what one call over all their steps computes.

Spans (``utils/telemetry.py``, recorded only under ``torch.profiler``): one
root ``sgd`` a call, and a step's ``sgd.batch`` (``host_batch``),
``sgd.upload``, ``sgd.forward`` (``training_loss``, the counter
``nms.sweeps`` inside it), ``sgd.backward``, ``sgd.step`` (the clip and the
optimizer) and ``sgd.loss_read`` (the step's one host read of its loss);
counters ``sgd.steps`` and ``sgd.gt_masks`` (GT masks uploaded).
"""

from __future__ import annotations

import copy
import os
import pickle
import re
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from online_detection_tpu_torch.data import transforms
from online_detection_tpu_torch.engine import losses
from online_detection_tpu_torch.models import resnet
from online_detection_tpu_torch.models.anchors import anchor_visibility, grid_anchors
from online_detection_tpu_torch.models.detector import DetectorParams
from online_detection_tpu_torch.models.heads import mask_deconv, mask_pretrained_logits
from online_detection_tpu_torch.models.rpn import propose, rpn_features, rpn_pretrained
from online_detection_tpu_torch.ops.roi_align import roi_align
from online_detection_tpu_torch.utils.device import ieee_fp32, resolve_device
from online_detection_tpu_torch.utils.telemetry import (
    MetricLogger,
    annotate,
    count,
    setup_logger,
    teardown_logger,
)

CLIP_NORM = 35.0  # batch-of-one SGD stability guard


class SGDConfig(NamedTuple):
    base_lr: float = 0.0025
    momentum: float = 0.9
    weight_decay: float = 5e-4
    warmup_iters: int = 500
    warmup_factor: float = 1.0 / 3
    steps: tuple = (48000, 64000)
    gamma: float = 0.1
    max_iter: int = 72000
    freeze_backbone: bool = False
    freeze_rpn_except_logits: bool = False
    freeze_heads_except_predictor: bool = False
    post_nms_train: int = 300
    roi_batch: int = 512


def lr_schedule(cfg: SGDConfig):
    """step -> learning rate (linear warmup from ``warmup_factor``, then
    ``gamma`` at each of ``steps``), in float32 arithmetic as the JAX
    package evaluates it."""
    f32 = np.float32

    def fn(step: int) -> float:
        if step < cfg.warmup_iters:
            warm = f32(cfg.warmup_factor) + f32(1 - cfg.warmup_factor) * f32(step) / f32(
                max(cfg.warmup_iters, 1))
        else:
            warm = f32(1.0)
        decay = f32(cfg.gamma) ** f32(sum(step >= s for s in cfg.steps))
        return float(f32(cfg.base_lr) * warm * decay)

    return fn


def named_leaves(params: DetectorParams) -> List[Tuple[str, torch.Tensor]]:
    """Every tensor of the network with its JAX tree path, in module order:
    ``backbone/res2/0/branch2a/w``, ``rpn/conv_w``, ``mask_head/logits_w``,
    ``box_predictor/cls_w`` (a conv's ``weight`` is the tree's ``w``)."""
    out = []
    for name, t in params.named_buffers():
        path = name.replace(".", "/")
        if path.endswith("/weight"):
            path = path[: -len("weight")] + "w"
        out.append((path, t))
    return out


def freeze_mask(params: DetectorParams, cfg: SGDConfig) -> Dict[str, float]:
    """JAX tree path -> 0.0 (frozen) or 1.0, per the reference's freeze
    groups (``train_feature_task.py:109-144``)."""

    def path_mask(path: str) -> float:
        if cfg.freeze_backbone and re.match(r"backbone/(stem|res2|res3|res4)", path):
            return 0.0
        if cfg.freeze_rpn_except_logits and path.startswith("rpn/conv"):
            return 0.0
        if cfg.freeze_heads_except_predictor and (
                path.startswith("backbone/res5") or path.startswith("mask_head/w")
                or path.startswith("mask_head/b")):
            return 0.0
        return 1.0

    return {path: path_mask(path) for path, _ in named_leaves(params)}


def project_gt_masks(masks: torch.Tensor, matched: torch.Tensor, boxes: torch.Tensor,
                     out: int = 14) -> torch.Tensor:
    """``project_mask_on_box(masks[matched[s]], boxes[s], out)`` for every
    sample s -> [S, out, out], without gathering whole masks: the bilinear
    sampling along y reads only the two mask rows of each output row."""
    h, w = masks.shape[-2:]
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    ks = torch.arange(out, dtype=torch.float32, device=masks.device)

    def positions(start, size, dim):  # [S, out] sample positions, clamped
        size = size.clamp(min=1.0)
        return (start[:, None] + (ks + 0.5) / out * size[:, None] - 0.5).clamp(0.0, dim - 1.0)

    py = positions(y1, y2 - y1 + 1.0, h)
    low = torch.floor(py)
    fy = (py - low)[..., None]
    lo = low.long()
    g = matched[:, None]
    rows = masks[g, lo].float() * (1.0 - fy) + masks[g, (lo + 1).clamp(max=h - 1)].float() * fy
    px = positions(x1, x2 - x1 + 1.0, w)
    lowx = torch.floor(px)[..., None]
    fx = (px[..., None] - lowx)
    grid = torch.arange(w, dtype=torch.float32, device=masks.device)
    wx = (grid == lowx) * (1.0 - fx) + (grid == lowx + 1.0) * fx  # [S, out, W]
    return torch.einsum("siw,sjw->sij", rows, wx)


def training_loss(params: DetectorParams, batch: Dict[str, torch.Tensor],
                  anchors: torch.Tensor, cfg: SGDConfig, with_mask: bool,
                  uniforms: Optional[Sequence[torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Full Mask R-CNN loss of one image. ``batch``: the normalised canvas
    ``image`` [H, W, 3] (or the backbone's ``c4`` [h, w, C] in the
    train-from-features mode), ``image_size`` (w, h), padded ``gt_boxes``,
    ``gt_labels``, ``gt_valid``, the anchors' ``visibility`` and, with
    masks, ``gt_masks`` [G, H, W]. ``uniforms``: the four draws the samplers
    consume (RPN positives, RPN negatives, RoI positives, RoI negatives),
    else drawn from ``generator``."""
    u_rpn = u_roi = None
    if uniforms is not None:
        u_rpn, u_roi = tuple(uniforms[:2]), tuple(uniforms[2:])
    gt_boxes, gt_labels, gt_valid = batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"]

    if "c4" in batch:  # train-from-backbone-features mode
        c4 = batch["c4"][None]
    else:
        c4 = resnet.backbone_c4(params.backbone,
                                transforms.normalize_canvas(batch["image"])[None])
    t = rpn_features(params.rpn, c4)
    logits, deltas = rpn_pretrained(params.rpn, t)
    flat_logits = logits[0].reshape(-1)
    flat_deltas = deltas[0].reshape(-1, 4)
    loss_rpn = losses.rpn_loss(flat_logits, flat_deltas, anchors, batch["visibility"],
                               gt_boxes, gt_valid, uniforms=u_rpn, generator=generator)

    prop_boxes, _, prop_valid = propose(
        flat_logits.detach()[None], flat_deltas.detach()[None], anchors,
        batch["image_size"].float()[None], post_nms_top_n=cfg.post_nms_train)
    # training-time add_gt_proposals
    all_boxes = torch.cat([prop_boxes[0], gt_boxes], dim=0)
    all_valid = torch.cat([prop_valid[0], gt_valid], dim=0)
    sample = losses.sample_rois(all_boxes, all_valid, gt_boxes, gt_labels, gt_valid,
                                batch_per_image=cfg.roi_batch, uniforms=u_roi,
                                generator=generator)

    pooled = roi_align(c4[0], sample.boxes)
    res5 = resnet.res5_feature_map(params.backbone, pooled)
    feats = res5.mean(dim=(1, 2))
    bp = params.box_predictor
    cls_logits = feats @ bp.cls_w + bp.cls_b
    box_deltas = feats @ bp.bbox_w + bp.bbox_b
    total = loss_rpn + losses.box_head_loss(cls_logits, box_deltas, sample, gt_boxes)
    if with_mask:
        mask_logits = mask_pretrained_logits(params.mask_head,
                                             mask_deconv(params.mask_head, res5))
        gt_m = project_gt_masks(batch["gt_masks"], sample.matched_gt, sample.boxes, 14)
        total = total + losses.mask_head_loss(mask_logits, sample, (gt_m >= 0.5).float())
    return total


def trainable_copy(params: DetectorParams, dev: torch.device,
                   cfg: SGDConfig) -> Tuple[DetectorParams, List[torch.Tensor]]:
    """A deep copy of ``params`` on ``dev`` (every tensor a fresh clone made
    outside ``inference_mode``) and its tensors left trainable by the freeze
    groups, with ``requires_grad`` set."""
    with torch.inference_mode(False):
        out = copy.deepcopy(params)
        for module in out.modules():
            for name, buf in module._buffers.items():
                if buf is not None:
                    module._buffers[name] = buf.detach().to(dev).clone()
    mask = freeze_mask(out, cfg)
    trainable = [t for path, t in named_leaves(out) if mask[path]]
    for t in trainable:
        t.requires_grad_(True)
    return out, trainable


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """In place, as ``optax.clip_by_global_norm`` computes it: with
    ``norm = sqrt(sum of squares)`` over all the gradients, each becomes
    ``g / norm * max_norm`` unless ``norm < max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``). Returns the norm."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def sgd_step(opt: torch.optim.SGD, trainable: Sequence[torch.Tensor], lr: float) -> None:
    """One optimizer step on the gradients autograd left: a zero gradient
    where the loss did not reach a tensor, the global-norm clip, then
    ``opt`` (weight decay, momentum) at learning rate ``lr``."""
    for t in trainable:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    clip_by_global_norm([t.grad for t in trainable], CLIP_NORM)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


class SGDRun:
    """The state of one SGD run that ``do_train`` hands from call to call:
    ``iteration`` (the next step's index), the trained ``params`` and the
    ``trainable`` tensors among them (on the device, no copy between calls),
    the optimizer ``opt`` (its momentum buffers), and the host generator
    ``host_rng`` with the image ``order`` drawn from it. Empty until the
    first call starts the run."""

    def __init__(self):
        self.iteration = 0
        self.params: Optional[DetectorParams] = None
        self.trainable: List[torch.Tensor] = []
        self.opt: Optional[torch.optim.SGD] = None
        self.host_rng: Optional[np.random.Generator] = None
        self.order: Optional[np.ndarray] = None

    @property
    def started(self) -> bool:
        return self.params is not None

    def momentum(self) -> List[Optional[torch.Tensor]]:
        """Each trainable tensor's momentum buffer (None before its first
        step)."""
        if self.opt is None:
            return [None] * len(self.trainable)
        return [self.opt.state.get(t, {}).get("momentum_buffer") for t in self.trainable]


def parse_time_budget(spec: Optional[str]) -> Optional[float]:
    """"XXh:YYm:ZZs" -> seconds (``run_experiment_fine_tuning.py:19``)."""
    if not spec:
        return None
    m = re.match(r"(\d+)h:(\d+)m:(\d+)s", spec)
    if not m:
        raise ValueError(f"bad --train_for_time spec: {spec}")
    hh, mm, ss = map(int, m.groups())
    return hh * 3600 + mm * 60 + ss


def host_batch(dataset, i, canvas_hw, min_size, max_size, gt_cap, anchors_np, with_mask,
                flip_prob, host_rng, from_feat):
    """One image's step inputs as host arrays, built as the JAX package's
    ``do_train`` builds them (scaled, padded GT; optional content flip)."""
    ch, cw = canvas_hw
    anno = dataset.get_annotation(i)
    do_flip = False
    if from_feat:  # train-from-backbone-features mode
        c4, scale, (sw, sh) = dataset.load_features(i)
        batch = {"c4": c4}
    else:
        rgb = dataset.load_image(i)
        canvas, scale, (sw, sh) = transforms.preprocess_image(rgb, canvas_hw, min_size,
                                                              max_size)
        do_flip = flip_prob > 0 and host_rng.random() < flip_prob
        if do_flip:  # mirror the content region, not the padding
            canvas[:sh, :sw] = canvas[:sh, :sw, :][:, ::-1]
        batch = {"image": canvas}
    boxes = transforms.scale_boxes(anno.boxes, scale)
    if do_flip and len(boxes):
        flipped = boxes.copy()
        flipped[:, 0] = sw - 1 - boxes[:, 2]
        flipped[:, 2] = sw - 1 - boxes[:, 0]
        boxes = flipped
    g = len(boxes)
    gb = np.zeros((gt_cap, 4), np.float32)
    gb[:g] = boxes[:gt_cap]
    gl = np.zeros((gt_cap,), np.int64)
    gl[:g] = anno.labels[:gt_cap]
    batch.update({
        "image_size": np.asarray([sw, sh], np.float32),
        "gt_boxes": gb,
        "gt_labels": gl,
        "gt_valid": np.arange(gt_cap) < g,
        "visibility": anchor_visibility(anchors_np, (sw, sh)),
    })
    if with_mask:
        masks = dataset.load_masks(i, anno)
        gm = np.zeros((gt_cap, ch, cw), np.float32)
        for j in range(min(g, gt_cap)):
            ys = np.clip((np.arange(ch) / scale).astype(int), 0, masks.shape[1] - 1)
            xs = np.clip((np.arange(cw) / scale).astype(int), 0, masks.shape[2] - 1)
            gm[j] = masks[j][np.ix_(ys, xs)]
        if do_flip:
            gm[:, :sh, :sw] = gm[:, :sh, :sw][:, :, ::-1]
        batch["gt_masks"] = gm
    return batch


def do_train(
    params: DetectorParams,
    dataset,
    canvas_hw,
    cfg: SGDConfig,
    generator: Optional[torch.Generator] = None,
    with_mask: bool = False,
    time_budget: Optional[float] = None,
    min_size: int = 600,
    max_size: int = 1333,
    gt_cap: int = 20,
    log_every: int = 20,
    checkpoint_period: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    val_fn=None,
    val_period: Optional[int] = None,
    flip_prob: float = 0.0,
    draws=None,
    device=None,
    run: Optional[SGDRun] = None,
):
    """The SGD loop, one image a step -> (trained params on ``device``,
    loss history of this call's steps).

    Steps run from ``run.iteration`` (0 for a new run) up to
    ``cfg.max_iter``. ``run``, when given, carries the run across calls: an
    empty ``SGDRun`` is started from ``params`` (its trainable copy, a fresh
    optimizer, the order drawn), one that a call already started goes on
    with its own tensors, optimizer and generator, and ``params`` is not
    read; the returned params are ``run.params``.

    ``draws[it]``, when given, holds step ``it``'s four sampler uniforms
    (``training_loss``); otherwise they come from ``generator`` (one of the
    two is required). The image order and the flips come from
    ``np.random.default_rng(0)``, as in the JAX package. ``flip_prob``:
    training-time horizontal flip (``INPUT.HORIZONTAL_FLIP_PROB_TRAIN``),
    skipped in the train-from-features mode (a dataset with
    ``load_features``). Periodic checkpoints are pickles of the JAX tree with
    numpy leaves (``models/weights.py::tree_from_params``); ``val_fn(params,
    it)`` runs every ``val_period`` steps. ``device`` defaults to the card."""
    from online_detection_tpu_torch.models.weights import tree_from_params

    dev = resolve_device(device)
    if generator is None and draws is None:
        raise ValueError("do_train needs a torch.Generator or the draws of every step")
    run = SGDRun() if run is None else run
    net = run.params if run.started else params
    if net.box_predictor is None or (with_mask and net.mask_head is None):
        raise ValueError("do_train needs a box predictor, and a mask head with masks")
    ch, cw = canvas_hw
    anchors_np = grid_anchors(ch // 16, cw // 16)
    anchors = torch.from_numpy(anchors_np).to(dev)
    n = len(dataset)
    if not run.started:
        run.params, run.trainable = trainable_copy(params, dev, cfg)
        run.opt = torch.optim.SGD(run.trainable, lr=cfg.base_lr, momentum=cfg.momentum,
                                  weight_decay=cfg.weight_decay)
        run.host_rng = np.random.default_rng(0)
        run.order = run.host_rng.permutation(n)
    else:
        for t in run.trainable:
            t.requires_grad_(True)
    params, trainable, opt, host_rng, order = (run.params, run.trainable, run.opt,
                                               run.host_rng, run.order)
    lr_fn = lr_schedule(cfg)

    # fresh handlers per run, so that an earlier run's checkpoint_dir stops
    # receiving this run's lines
    teardown_logger("online_detection_tpu_torch.trainer")
    logger = setup_logger("online_detection_tpu_torch.trainer", checkpoint_dir)
    meters = MetricLogger()
    logger.info("start SGD: iters %d to %d over %d images (budget %s)", run.iteration,
                cfg.max_iter, n, time_budget)
    from_feat = hasattr(dataset, "load_features")
    t0 = time.time()
    losses_hist = []
    t_iter = time.time()
    with annotate("sgd"):
        for it in range(run.iteration, cfg.max_iter):
            with annotate("sgd.batch"):
                host = host_batch(dataset, int(order[it % n]), canvas_hw, min_size, max_size,
                                   gt_cap, anchors_np, with_mask, flip_prob, host_rng, from_feat)
            with annotate("sgd.upload"):
                batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                         for k, v in host.items() if k != "gt_masks"}
                if with_mask:  # only the valid GTs' masks cross to the device; the rest are zeros
                    gm, g = host["gt_masks"], int(host["gt_valid"].sum())
                    batch["gt_masks"] = torch.zeros(gm.shape, dtype=torch.float32, device=dev)
                    batch["gt_masks"][:g] = torch.from_numpy(gm[:g]).to(dev)
                    count("sgd.gt_masks", g)
                uniforms = None
                if draws is not None:
                    uniforms = [torch.as_tensor(np.array(u, np.float32), device=dev)
                                for u in draws[it]]
            with ieee_fp32():
                with annotate("sgd.forward"):
                    loss = training_loss(params, batch, anchors, cfg, with_mask, uniforms,
                                         generator)
                with annotate("sgd.backward"):
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                with annotate("sgd.step"):
                    sgd_step(opt, trainable, lr_fn(it))
            with annotate("sgd.loss_read"):
                losses_hist.append(float(loss.detach()))
            run.iteration = it + 1
            count("sgd.steps")
            # the reference's MetricLogger line: ETA, smoothed loss, peak memory
            meters.update(time=time.time() - t_iter, loss=losses_hist[-1])
            t_iter = time.time()
            if it % log_every == 0:
                logger.info(meters.log_line(it, cfg.max_iter))
            if checkpoint_period and checkpoint_dir and it > 0 and it % checkpoint_period == 0:
                os.makedirs(checkpoint_dir, exist_ok=True)
                with open(os.path.join(checkpoint_dir, f"model_{it:07d}.pkl"), "wb") as f:
                    pickle.dump(tree_from_params(params), f)
            if val_fn and val_period and it > 0 and it % val_period == 0:
                val_fn(params, it)
            if time_budget is not None and time.time() - t0 > time_budget:
                logger.info("time budget reached at iter %d", it)
                break
    logger.info("done: %d iters in %.1fs", len(losses_hist), time.time() - t0)
    teardown_logger("online_detection_tpu_torch.trainer")
    opt.zero_grad(set_to_none=True)
    for t in trainable:
        t.requires_grad_(False)
    return params, losses_hist
