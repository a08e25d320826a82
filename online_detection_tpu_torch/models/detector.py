"""The assembled detector: backbone -> RPN -> RoI heads (counterpart of
``models/detector.py``).

    image -> ResNet-50-C4 -> RPN conv -> {pretrained | on-line} head
          -> proposals (top-300) -> RoIAlign(14x14) -> res5 -> avgpool
          -> on-line box predictor -> detection postprocess (top-100)
          -> RoIAlign on detections -> res5 -> conv5_mask deconv
          -> per-pixel FALKON of each detection's class -> 14x14 masks.

``detect_pretrained`` is the stock Mask R-CNN path for checkpoint
evaluation: the pretrained RPN, res5, the linear box predictors with a
softmax, per-class NMS, and the 1x1 mask logits.

``detect_batched`` runs a batch of padded canvases. Per-image stages (top-k,
NMS, RoIAlign) take the image axis as a batch axis; rowwise stages (the
on-line heads, res5) run on the batch flattened into rows. Each batch
launches the stem kernel once, the Gaussian mmv kernel three times (RPN,
detector, mask) and the RoIAlign kernel twice.

During ``detect_batched``, float32 matmuls and convs run in IEEE fp32 (TF32
off, ``utils.device.ieee_fp32``; the caller's flags come back after the
call): the head math (z-scoring, FALKON, RLS, box decode) must not lose
digits. The conv trunk runs in ``compute_dtype`` (bf16 on the card by
default).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn

from online_detection_tpu_torch.data.transforms import normalize_canvas
from online_detection_tpu_torch.models import resnet
from online_detection_tpu_torch.models.heads import (
    BoxPredictor,
    MaskHead,
    OnlineDetectorModels,
    OnlineMaskModels,
    box_predict,
    mask_deconv,
    mask_predict_labels,
    mask_pretrained_logits,
)
from online_detection_tpu_torch.models.postprocess import (
    NEG_INF,
    Detections,
    postprocess_detections,
    select_mask_channel,
)
from online_detection_tpu_torch.models.rpn import (
    OnlineRPNModels,
    RPNHead,
    propose,
    rpn_features,
    rpn_online_flat,
    rpn_pretrained,
)
from online_detection_tpu_torch.ops.nms import nms, top_k
from online_detection_tpu_torch.ops.roi_align import roi_align_batched
from online_detection_tpu_torch.utils import boxes as box_ops
from online_detection_tpu_torch.utils.device import ieee_fp32, resolve_device


class DetectorConfig(NamedTuple):
    """Static inference configuration (values = the shipped experiment
    configs)."""

    pre_nms_top_n: int = 1000
    post_nms_top_n: int = 300
    rpn_nms_thresh: float = 0.7
    rpn_min_size: float = 0.0
    score_thresh: float = -2.0
    nms_thresh: float = 0.3
    detections_per_img: int = 100
    pooler_resolution: int = 14
    pooler_scale: float = 1.0 / 16.0
    # kept for parity with the JAX package's config; it bounds the separable
    # intermediate there and has no effect here: the RoIAlign kernel keeps
    # no intermediate
    roi_chunk: Optional[int] = None
    # --normalize_features_regressor_detector (see heads.box_predict)
    normalize_regressor_features: bool = False
    # conv-trunk dtype: "float32", "bfloat16", or None = bfloat16 on the
    # card, float32 on the CPU; ODTPU_COMPUTE_DTYPE overrides it
    compute_dtype: Optional[str] = None


_TRUNK_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_compute_dtype(cfg: DetectorConfig, device) -> torch.dtype:
    """The conv trunk's dtype, resolved in the JAX package's order:
    ``ODTPU_COMPUTE_DTYPE`` (``float32`` or ``bfloat16``; an empty value
    counts as unset), then ``cfg.compute_dtype``, then the device's default,
    bf16 on the card and f32 on the CPU. Any other name raises."""
    name = os.environ.get("ODTPU_COMPUTE_DTYPE") or cfg.compute_dtype
    if name is None:
        name = "bfloat16" if torch.device(device).type == "cuda" else "float32"
    if name not in _TRUNK_DTYPES:
        raise ValueError(f"unknown trunk dtype {name!r} (ODTPU_COMPUTE_DTYPE or "
                         f"DetectorConfig.compute_dtype): use one of {sorted(_TRUNK_DTYPES)}")
    return _TRUNK_DTYPES[name]


@dataclass
class OnlineModelSet:
    """All on-line modules; rpn and mask may be None (pretrained RPN /
    detection-only)."""

    rpn: Optional[OnlineRPNModels]
    detector: OnlineDetectorModels
    mask: Optional[OnlineMaskModels]

    def to(self, device) -> "OnlineModelSet":
        return OnlineModelSet(
            None if self.rpn is None else self.rpn.to(device),
            self.detector.to(device),
            None if self.mask is None else self.mask.to(device),
        )


class DetectorParams(nn.Module):
    """The frozen network: trunk + res5, RPN head, mask head, and the stock
    box predictor. A checkpoint may lack the mask head (a Caffe2 file
    without ``conv5_mask_*``) or the box predictor; those are None then."""

    def __init__(self, backbone: resnet.ResNetC4, rpn: RPNHead,
                 mask_head: Optional[MaskHead] = None,
                 box_predictor: Optional[BoxPredictor] = None):
        super().__init__()
        self.backbone = backbone
        self.rpn = rpn
        self.mask_head = mask_head
        self.box_predictor = box_predictor


def init_detector_params(seed: int = 0, num_anchors: int = 15, num_classes: int = 22,
                         stages=resnet.R50_STAGES,
                         channels=resnet.STAGE_CHANNELS) -> DetectorParams:
    """Random weights with the full schema from a numpy seed (on the CPU)."""
    rng = np.random.default_rng(seed)
    c4 = channels[2][1]
    c5 = channels[3][1]

    def normal(shape, std):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(std))

    rpn = RPNHead(normal((c4, c4, 3, 3), 0.01), torch.zeros(c4),
                  normal((c4, num_anchors), 0.01), torch.zeros(num_anchors),
                  normal((c4, 4 * num_anchors), 0.01), torch.zeros(4 * num_anchors))
    mask_head = MaskHead(normal((c5, 256, 2, 2), (2.0 / (4 * c5)) ** 0.5), torch.zeros(256),
                         normal((256, num_classes), 0.01), torch.zeros(num_classes))
    backbone = resnet.init_resnet50_params(int(rng.integers(2**31)), True, stages, channels)
    return DetectorParams(backbone, rpn, mask_head)


def rpn_scores_deltas(head: RPNHead, online_rpn: Optional[OnlineRPNModels],
                      t: torch.Tensor):
    """Pretrained or on-line RPN head on conv features t [B, H, W, C] ->
    (scores [B, H*W*A], deltas [B, H*W*A, 4])."""
    b, h, w, ch = t.shape
    if online_rpn is None:
        logits, deltas = rpn_pretrained(head, t)
    else:
        logits, deltas = rpn_online_flat(online_rpn, t.reshape(b * h * w, ch))
    return logits.reshape(b, -1), deltas.reshape(b, -1, 4)


def _on(dev: torch.device, name: str, t: torch.Tensor) -> None:
    if t.device.type != dev.type:
        raise ValueError(f"{name} is on {t.device}; move it to {dev} first")


@ieee_fp32()
@torch.inference_mode()
def detect_batched(
    params: DetectorParams,
    online: OnlineModelSet,
    anchors,  # [HW*A, 4]
    images,  # [B, H, W, 3] padded canvases (uint8 RGB or normalized f32)
    image_sizes,  # [B, 2] true (width, height)
    cfg: DetectorConfig = DetectorConfig(),
    with_masks: bool = True,
    gt_boxes=None,  # [B, K, 4]
    gt_labels=None,  # [B, K]
    gt_valid=None,  # [B, K] bool
    device=None,
):
    """Image-batched inference -> (detections [B, D], mask probabilities
    [B, D, 14, 14] or None, proposals [B, R, 4], proposals_valid [B, R]).

    ``device`` defaults to the card; the network and the on-line models must
    already live there. With ``gt_boxes`` the detections are replaced by the
    ground truth before the mask head (the mask-quality protocol)."""
    dev = resolve_device(device)
    _on(dev, "params", params.rpn.conv_w)
    _on(dev, "online models", online.detector.falkon.centers)
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
    images = torch.as_tensor(images, device=dev)
    image_sizes = torch.as_tensor(image_sizes, dtype=torch.float32, device=dev)

    b = images.shape[0]
    images = normalize_canvas(images).to(resolve_compute_dtype(cfg, dev))
    c4 = resnet.backbone_c4(params.backbone, images)  # [B, h, w, 1024]
    t = rpn_features(params.rpn, c4)
    scores, deltas = rpn_scores_deltas(params.rpn, online.rpn, t)
    prop_boxes, _, prop_valid = propose(
        scores, deltas, anchors, image_sizes,
        pre_nms_top_n=cfg.pre_nms_top_n, post_nms_top_n=cfg.post_nms_top_n,
        nms_thresh=cfg.rpn_nms_thresh, min_size=cfg.rpn_min_size,
    )

    p = cfg.pooler_resolution
    pooled = roi_align_batched(c4, prop_boxes, p, cfg.pooler_scale)  # [B, R, P, P, C]
    r = pooled.shape[1]
    feats = resnet.res5_head(params.backbone, pooled.reshape((b * r,) + pooled.shape[2:]))
    cls_scores, box_deltas = box_predict(online.detector, feats,
                                         cfg.normalize_regressor_features)
    dets = postprocess_detections(
        prop_boxes, prop_valid, cls_scores.reshape(b, r, -1),
        box_deltas.reshape(b, r, -1), image_sizes,
        score_thresh=cfg.score_thresh, nms_thresh=cfg.nms_thresh,
        detections_per_img=cfg.detections_per_img,
    )
    if gt_boxes is not None:
        gt_valid = torch.as_tensor(gt_valid, dtype=torch.bool, device=dev)
        gt_boxes = torch.as_tensor(gt_boxes, dtype=torch.float32, device=dev)
        gt_labels = torch.as_tensor(gt_labels, device=dev).to(torch.int32)
        dets = Detections(boxes=gt_boxes * gt_valid[..., None],
                          scores=gt_valid.float(), labels=gt_labels * gt_valid,
                          valid=gt_valid)

    mask_probs = None
    if with_masks and online.mask is not None:
        pooled2 = roi_align_batched(c4, dets.boxes, p, cfg.pooler_scale)  # [B, D, P, P, C]
        d = pooled2.shape[1]
        res5 = resnet.res5_feature_map(params.backbone,
                                       pooled2.reshape((b * d,) + pooled2.shape[2:]))
        deconv = mask_deconv(params.mask_head, res5)
        mask_probs = mask_predict_labels(online.mask, deconv,
                                         dets.labels.reshape(b * d)).reshape(b, d, p, p)
    return dets, mask_probs, prop_boxes, prop_valid


def detect(params, online, anchors, image, image_size, cfg: DetectorConfig = DetectorConfig(),
           with_masks: bool = True,
           gt_boxes=None,  # [K, 4] canvas coords
           gt_labels=None,  # [K]
           gt_valid=None,  # [K] bool
           device=None):
    """Single-image inference: ``detect_batched`` on a batch of one. With
    ``gt_boxes`` the detections are replaced by the ground truth (labels from
    it, score 1) before the mask head."""
    image = torch.as_tensor(image)[None]
    size = torch.as_tensor(image_size, dtype=torch.float32)[None]
    if gt_boxes is not None:
        gt_boxes, gt_labels, gt_valid = (torch.as_tensor(g)[None]
                                         for g in (gt_boxes, gt_labels, gt_valid))
    dets, masks, props, pvalid = detect_batched(params, online, anchors, image, size, cfg,
                                                with_masks, gt_boxes, gt_labels, gt_valid,
                                                device=device)
    one = Detections(dets.boxes[0], dets.scores[0], dets.labels[0], dets.valid[0])
    return one, None if masks is None else masks[0], props[0], pvalid[0]


@ieee_fp32()
@torch.inference_mode()
def detect_pretrained(
    params: DetectorParams,
    anchors,  # [HW*A, 4]
    image,  # [H, W, 3] padded canvas (uint8 RGB or normalized f32)
    image_size,  # (width, height) true size
    cfg: DetectorConfig = DetectorConfig(),
    with_masks: bool = False,
    score_thresh: float = 0.05,
    nms_thresh: float = 0.5,
    device=None,
):
    """Stock Mask R-CNN inference (the softmax path) of one image, for
    checkpoint evaluation: pretrained RPN proposals -> res5 -> linear cls /
    bbox predictors -> softmax, (10, 10, 5, 5) decode with the clipped exp,
    two-sided clip, per-class NMS (class 0 never kept), global top
    ``detections_per_img``. Returns (detections [D], mask probabilities
    [D, 14, 14] or None, proposals [R, 4], proposals_valid [R]); masks need
    ``with_masks`` and a mask head.

    ``device`` defaults to the card; ``params`` must already live there. The
    trunk runs in ``resolve_compute_dtype`` (bf16 on the card), the
    predictors in IEEE fp32."""
    dev = resolve_device(device)
    _on(dev, "params", params.rpn.conv_w)
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
    image = torch.as_tensor(image, device=dev)[None]
    size = torch.as_tensor(image_size, dtype=torch.float32, device=dev).reshape(1, 2)

    image = normalize_canvas(image).to(resolve_compute_dtype(cfg, dev))
    c4 = resnet.backbone_c4(params.backbone, image)  # [1, h, w, 1024]
    t = rpn_features(params.rpn, c4)
    scores, deltas = rpn_scores_deltas(params.rpn, None, t)
    prop_boxes, _, prop_valid = propose(
        scores, deltas, anchors, size,
        pre_nms_top_n=cfg.pre_nms_top_n, post_nms_top_n=cfg.post_nms_top_n,
        nms_thresh=cfg.rpn_nms_thresh, min_size=cfg.rpn_min_size,
    )
    p = cfg.pooler_resolution
    pooled = roi_align_batched(c4, prop_boxes, p, cfg.pooler_scale)[0]  # [R, P, P, C]
    feats = resnet.res5_head(params.backbone, pooled).float()  # [R, 2048]
    bp = params.box_predictor
    probs = torch.softmax(feats @ bp.cls_w + bp.cls_b, dim=-1)  # [R, C+1]
    box_deltas = feats @ bp.bbox_w + bp.bbox_b

    refined = box_ops.decode_boxes(box_deltas, prop_boxes[0], weights=(10.0, 10.0, 5.0, 5.0),
                                   clip_exp=True)
    refined = box_ops.clip_boxes_to_image(refined, size[0])
    r, n_cls = probs.shape
    per_class_boxes = refined.reshape(r, n_cls, 4).transpose(0, 1)  # [C+1, R, 4]
    per_class_scores = probs.T  # [C+1, R]
    keep = (per_class_scores > score_thresh) & prop_valid
    keep[0] = False  # background is never kept
    d = cfg.detections_per_img
    bx, sc, v, _ = nms(per_class_boxes, per_class_scores, keep, nms_thresh, d)  # [C+1, D]
    flat_scores = torch.where(v, sc, torch.full_like(sc, NEG_INF)).reshape(-1)
    flat_boxes = bx.reshape(-1, 4)
    labels = torch.arange(n_cls, dtype=torch.int32, device=dev)[:, None].expand(n_cls, d)
    labels = labels.reshape(-1)
    top_scores, idx = top_k(flat_scores, d)
    out_valid = top_scores > NEG_INF / 2
    dets = Detections(
        boxes=flat_boxes[idx] * out_valid[:, None],
        scores=torch.where(out_valid, top_scores, torch.zeros_like(top_scores)),
        labels=torch.where(out_valid, labels[idx], torch.zeros_like(labels[idx])),
        valid=out_valid,
    )

    mask_probs = None
    if with_masks and params.mask_head is not None:
        pooled2 = roi_align_batched(c4, dets.boxes[None], p, cfg.pooler_scale)[0]
        res5 = resnet.res5_feature_map(params.backbone, pooled2)  # [D, 7, 7, 2048]
        logits = mask_pretrained_logits(params.mask_head, mask_deconv(params.mask_head, res5))
        mask_probs = select_mask_channel(logits, dets.labels)
    return dets, mask_probs, prop_boxes[0], prop_valid[0]
