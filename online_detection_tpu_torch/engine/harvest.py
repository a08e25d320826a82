"""Feature harvesting, the training-time extraction pass (counterpart of
``engine/harvest.py``).

Per canvas batch, with the GT boxes prepended to the RPN proposals:

- RPN (per anchor-shape class): negatives are visible anchors with best IoU
  < 0.3, ``negatives_to_pick`` of them drawn with replacement when the pool
  is larger; positives are anchors with IoU > 0.7 plus, for a GT that has
  none, its max-IoU anchors; their targets encode the assigned GT.
- Detector (per class): positives are the GT rows' own features; negatives
  are rows with per-class IoU < 0.3 when the class is in the image, any row
  otherwise; COXY rows (IoU > 0.6 with their GT) carry regression targets.
- Segmentation (per GT): conv5_mask pixel features of the GT row, split by
  the projected 14x14 mask and subsampled by ``sampling_factor`` without
  replacement.

Every function takes a leading image axis and batches images and classes
with tensor ops. Draws come from the caller's ``torch.Generator`` or are
passed in precomputed (``draws`` / ``uniforms``, e.g. the JAX package's own
draws in the tests); ``HarvestConfig.parity_sampling`` replaces them with
the pinned scheme of the JAX package's parity tests. Sorts are stable.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from online_detection_tpu_torch.data.transforms import normalize_canvas
from online_detection_tpu_torch.models import resnet
from online_detection_tpu_torch.models.detector import (
    DetectorConfig,
    resolve_compute_dtype,
    rpn_scores_deltas,
)
from online_detection_tpu_torch.models.heads import mask_deconv
from online_detection_tpu_torch.models.rpn import OnlineRPNModels, propose, rpn_features
from online_detection_tpu_torch.ops.roi_align import roi_align_fused2
from online_detection_tpu_torch.utils import boxes as box_ops
from online_detection_tpu_torch.utils.draws import randint_below, uniform, valid_first
from online_detection_tpu_torch.utils.telemetry import annotate


class HarvestConfig(NamedTuple):
    """Static shapes and knobs of the harvesting pass."""

    num_anchor_classes: int = 15
    num_classes: int = 21
    negatives_to_pick: int = 10  # ceil(B*I / num_images), per run
    rpn_neg_iou: float = 0.3
    rpn_pos_iou: float = 0.7
    det_neg_iou: float = 0.3
    reg_min_overlap: float = 0.6
    gt_cap: int = 20  # max GT boxes per image
    rpn_pos_cap: int = 64  # per-class positive-anchor slots per image
    coxy_cap: int = 256  # detector regression rows per image
    mask_pix_cap: int = 64  # sampled pixels per GT per polarity
    sampling_factor: float = 0.3
    # the pinned index scheme of the JAX package's parity tests in place of
    # draws (randint -> arange % n, randperm -> reversed arange)
    parity_sampling: bool = False


class RPNChunk(NamedTuple):
    neg: torch.Tensor  # [B, A, NPICK, 1024]
    neg_valid: torch.Tensor  # [B, A, NPICK]
    pos: torch.Tensor  # [B, A, PPOS, 1024]
    pos_valid: torch.Tensor  # [B, A, PPOS]
    coxy_y: torch.Tensor  # [B, A, PPOS, 4] regression targets of the positives
    pos_dropped: torch.Tensor  # [B, A] positives lost to the per-image cap


class DetChunk(NamedTuple):
    pos: torch.Tensor  # [B, G, 2048] GT-row features
    pos_labels: torch.Tensor  # [B, G] 1-based
    pos_valid: torch.Tensor  # [B, G]
    neg: torch.Tensor  # [B, C, NPICK, 2048]
    neg_valid: torch.Tensor  # [B, C, NPICK]
    coxy_x: torch.Tensor  # [B, COXY_CAP, 2048]
    coxy_y: torch.Tensor  # [B, COXY_CAP, 4]
    coxy_c: torch.Tensor  # [B, COXY_CAP] 1-based labels (float)
    coxy_valid: torch.Tensor  # [B, COXY_CAP]
    coxy_dropped: torch.Tensor  # [B] COXY rows lost to the per-image cap


class MaskChunk(NamedTuple):
    pos: torch.Tensor  # [B, G, PIX, 256]
    pos_valid: torch.Tensor  # [B, G, PIX]
    neg: torch.Tensor  # [B, G, PIX, 256]
    neg_valid: torch.Tensor  # [B, G, PIX]
    labels: torch.Tensor  # [B, G] 1-based
    labels_valid: torch.Tensor  # [B, G]
    dropped: torch.Tensor  # [B] sampled pixels lost to the PIX cap


class HarvestChunk(NamedTuple):
    rpn: Optional[RPNChunk]
    det: DetChunk
    mask: Optional[MaskChunk]
    average_recall: torch.Tensor  # [B]


def masked_sample(mask: torch.Tensor, n_out: int, parity: bool = False,
                  always_resample: bool = False, generator=None, draws=None):
    """Sampling from a masked pool along the last axis: all rows when count
    <= n_out, else n_out draws with replacement. -> (idx [..., n_out],
    valid [..., n_out]).

    ``parity``: the pinned scheme; with ``always_resample`` the pool rows
    cycle to n_out with duplicates (the reference's detector head), without
    it the first n_out pool rows are taken (its RPN head)."""
    n = mask.shape[-1]
    cnt = mask.sum(-1, keepdim=True)
    order = valid_first(mask)
    slot = torch.arange(n_out, device=mask.device)
    first = torch.minimum(slot, (cnt - 1).clamp(min=0))
    if parity:
        if always_resample:
            take = slot % cnt.clamp(min=1)
            valid = (cnt > 0).expand(*cnt.shape[:-1], n_out)
        else:
            take = first
            valid = slot < cnt.clamp(max=n_out)
    else:
        draws = randint_below(cnt.clamp(min=1), n_out, generator, draws)
        take = torch.where(cnt > n_out, draws, first)
        valid = slot < cnt.clamp(max=n_out)
    return order.gather(-1, take.clamp(0, n - 1)), valid


def compact(mask: torch.Tensor, n_out: int):
    """Valid-first compaction along the last axis, truncated at n_out."""
    n = mask.shape[-1]
    cnt = mask.sum(-1, keepdim=True)
    slot = torch.arange(n_out, device=mask.device)
    idx = valid_first(mask).gather(-1, slot.clamp(max=n - 1).expand(*mask.shape[:-1], n_out))
    return idx, slot < cnt.clamp(max=n_out)


def random_subsample(mask: torch.Tensor, frac: float, n_out: int, parity: bool = False,
                     generator=None, uniforms=None):
    """randperm(count)[:floor(frac * count)] without replacement, along the
    last axis -> (idx [..., n_out], valid). ``parity``: the last
    floor(frac * count) valid rows in descending order."""
    n = mask.shape[-1]
    cnt = mask.sum(-1, keepdim=True)
    dev = mask.device
    if parity:
        pri = -torch.arange(n, dtype=torch.float32, device=dev) + (~mask).float() * 1e9
    else:
        u = uniform(mask.shape, generator, dev) if uniforms is None else \
            torch.as_tensor(uniforms, device=dev)
        pri = u + (~mask).float() * 1e9  # random order, valid first
    order = torch.sort(pri, dim=-1, stable=True).indices
    take = torch.floor(frac * cnt.float()).long()
    slot = torch.arange(n_out, device=dev)
    idx = order.gather(-1, slot.clamp(max=n - 1).expand(*mask.shape[:-1], n_out))
    return idx, slot < take.clamp(max=n_out)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] gathered along N by idx [B, ...] -> [B, ..., ...]."""
    bi = torch.arange(x.shape[0], device=x.device).reshape((-1,) + (1,) * (idx.dim() - 1))
    return x[bi, idx]


# --------------------------------------------------------------------------
# RPN harvesting


def harvest_rpn(t: torch.Tensor, anchors: torch.Tensor, visibility: torch.Tensor,
                gt_boxes: torch.Tensor, gt_valid: torch.Tensor, cfg: HarvestConfig,
                generator=None, draws=None) -> RPNChunk:
    """t [B, H, W, 1024] conv features, anchors [H*W*A, 4], visibility
    [B, H*W*A], gt_boxes [B, G, 4], gt_valid [B, G]; ``draws`` [B, A, NPICK]."""
    a_cls = cfg.num_anchor_classes
    b, h, w, ch = t.shape
    dev = t.device
    feats = t.reshape(b, h * w, ch)
    iou = box_ops.box_iou(gt_boxes, anchors)  # [B, G, N]
    iou = torch.where(gt_valid[..., None], iou, torch.full_like(iou, -1.0))
    best_gt = iou.argmax(1)  # first max wins
    best_iou = iou.amax(1).clamp(min=0.0)  # no valid GT -> 0

    neg_pool = visibility & (best_iou < cfg.rpn_neg_iou)
    pos_hi = visibility & (best_iou > cfg.rpn_pos_iou)

    # GT rescue: a valid GT with no anchor above the threshold takes its
    # max-IoU anchors among those assigned to it
    assigned = best_gt[:, None, :] == torch.arange(gt_boxes.shape[1], device=dev)[None, :, None]
    covered = (pos_hi[:, None, :] & assigned).any(-1, keepdim=True)  # [B, G, 1]
    cand = visibility[:, None, :] & assigned
    maxv = torch.where(cand, best_iou[:, None, :], torch.full_like(cand, -1.0, dtype=iou.dtype))
    maxv = maxv.amax(-1, keepdim=True)
    rescue = (cand & (best_iou[:, None, :] == maxv) & gt_valid[..., None] & ~covered).any(1)
    pos_pool = pos_hi | rescue

    # anchor n <-> (location n // A, class n % A): class a's pool is column a
    def per_class(m):
        return m.reshape(b, h * w, a_cls).transpose(1, 2)  # [B, A, HW]

    neg2, pos2, best_gt2 = per_class(neg_pool), per_class(pos_pool), per_class(best_gt)
    neg_loc, neg_valid = masked_sample(neg2, cfg.negatives_to_pick, cfg.parity_sampling,
                                       generator=generator, draws=draws)
    pos_loc, pos_valid = compact(pos2, cfg.rpn_pos_cap)
    pos_idx = pos_loc * a_cls + torch.arange(a_cls, device=dev)[None, :, None]
    gt_for = _rows(gt_boxes, best_gt2.gather(-1, pos_loc))  # [B, A, PPOS, 4]
    targets = box_ops.encode_boxes(gt_for, anchors[pos_idx])
    dropped = (pos2.sum(-1) - cfg.rpn_pos_cap).clamp(min=0)
    return RPNChunk(_rows(feats, neg_loc), neg_valid, _rows(feats, pos_loc), pos_valid,
                    targets, dropped)


# --------------------------------------------------------------------------
# Detector harvesting


def harvest_detector(feats: torch.Tensor, boxes: torch.Tensor, rows_valid: torch.Tensor,
                     gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                     image_size: torch.Tensor, cfg: HarvestConfig, generator=None,
                     draws=None) -> DetChunk:
    """feats [B, R, 2048] pooled features (GT rows first), boxes [B, R, 4],
    rows_valid [B, R], gt_labels / gt_valid [B, G], image_size [B, 2]
    (width, height); ``draws`` [B, C, NPICK]."""
    g_cap, n_cls = cfg.gt_cap, cfg.num_classes
    dev = feats.device
    boxes = box_ops.clip_boxes_to_image(boxes, image_size[:, None, :].float())
    gt_boxes = boxes[:, :g_cap]

    iou_gt = box_ops.box_iou(gt_boxes, boxes)  # [B, G, R]
    iou_gt = torch.where(gt_valid[..., None] & rows_valid[:, None, :], iou_gt,
                         torch.zeros_like(iou_gt))
    labels0 = gt_labels.long() - 1
    onehot = (labels0[..., None] == torch.arange(n_cls, device=dev)) & gt_valid[..., None]
    overlap = (iou_gt[..., None] * onehot[:, :, None, :].to(iou_gt.dtype)).amax(1)  # [B, R, C]
    assoc = iou_gt.argmax(1)  # [B, R], first max wins
    assoc_iou = iou_gt.amax(1)

    pos = feats[:, :g_cap]
    pos_valid = gt_valid & rows_valid[:, :g_cap]

    assoc_cls = labels0.gather(1, assoc)  # [B, R] 0-based class of the assigned GT
    per_row_ov = overlap.gather(-1, (assoc_cls % n_cls)[..., None])[..., 0]
    coxy_mask = (rows_valid & gt_valid.gather(1, assoc) & (per_row_ov > cfg.reg_min_overlap)
                 & (assoc_iou > 0.0))
    cidx, cvalid = compact(coxy_mask, cfg.coxy_cap)
    coxy_x = _rows(feats, cidx)
    coxy_y = box_ops.encode_boxes(_rows(gt_boxes, assoc.gather(1, cidx)), _rows(boxes, cidx))
    coxy_c = (assoc_cls.gather(1, cidx) + 1).float()

    present = onehot.any(1)  # [B, C]
    pool_present = rows_valid[:, None, :] & (overlap.transpose(1, 2) < cfg.det_neg_iou)
    pool = torch.where(present[..., None], pool_present, rows_valid[:, None, :])  # [B, C, R]
    idx, valid = masked_sample(pool, cfg.negatives_to_pick, cfg.parity_sampling,
                               always_resample=True, generator=generator, draws=draws)
    # class present but no row under the threshold: nothing harvested
    valid = valid & (~present | pool_present.any(-1))[..., None]
    coxy_dropped = (coxy_mask.sum(-1) - cfg.coxy_cap).clamp(min=0)
    return DetChunk(pos, gt_labels, pos_valid, _rows(feats, idx), valid, coxy_x, coxy_y,
                    coxy_c, cvalid, coxy_dropped)


# --------------------------------------------------------------------------
# Segmentation harvesting


def harvest_mask(deconv_feats: torch.Tensor, gt_masks_14: torch.Tensor,
                 gt_labels: torch.Tensor, gt_valid: torch.Tensor, cfg: HarvestConfig,
                 generator=None, uniforms=None) -> MaskChunk:
    """deconv_feats [B, G, 14, 14, 256] conv5_mask of the GT rows,
    gt_masks_14 [B, G, 14, 14] masks projected on their boxes; ``uniforms``
    (positive, negative) priorities, each [B, G, 196]."""
    b, g, mh, mw, ch = deconv_feats.shape
    pix_pos = (gt_masks_14 >= 0.5).reshape(b, g, mh * mw)
    feats = deconv_feats.reshape(b, g, mh * mw, ch)
    u_pos, u_neg = (None, None) if uniforms is None else uniforms
    frac, cap, par = cfg.sampling_factor, cfg.mask_pix_cap, cfg.parity_sampling
    pi, pv = random_subsample(pix_pos, frac, cap, par, generator, u_pos)
    ni, nv = random_subsample(~pix_pos, frac, cap, par, generator, u_neg)
    pv, nv = pv & gt_valid[..., None], nv & gt_valid[..., None]
    want = (torch.floor(frac * pix_pos.sum(-1).float())
            + torch.floor(frac * (~pix_pos).sum(-1).float())).long()
    got = pv.sum(-1) + nv.sum(-1)
    dropped = (want * gt_valid - got).clamp(min=0).sum(-1)

    def pick(idx):
        return feats.gather(2, idx[..., None].expand(*idx.shape, ch))

    return MaskChunk(pick(pi), pv, pick(ni), nv, gt_labels, gt_valid, dropped)


def project_mask_on_box(mask: torch.Tensor, box: torch.Tensor, out: int = 14) -> torch.Tensor:
    """Crops masks [..., H, W] to their boxes [..., 4] and resamples them to
    [..., out, out] (bilinear): output pixel (i, j) samples the mask at the
    centre of cell (i, j) of the box's grid, through one separable sampling
    matrix per axis. The device twin of ``data/mask_project.py``."""
    h, w = mask.shape[-2:]
    box = box.float()
    x1, y1, x2, y2 = box.unbind(-1)
    bw = (x2 - x1 + 1.0).clamp(min=1.0)
    bh = (y2 - y1 + 1.0).clamp(min=1.0)
    ks = torch.arange(out, dtype=torch.float32, device=mask.device)

    def axis_weights(start, size, dim):  # [..., out, dim]
        pos = (start[..., None] + (ks + 0.5) / out * size[..., None] - 0.5).clamp(0.0, dim - 1.0)
        low = torch.floor(pos)
        frac = (pos - low)[..., None]
        grid = torch.arange(dim, dtype=torch.float32, device=mask.device)
        return (grid == low[..., None]) * (1.0 - frac) + (grid == low[..., None] + 1.0) * frac

    wy = axis_weights(y1, bh, h)
    wx = axis_weights(x1, bw, w)
    return torch.einsum("...ih,...hw,...jw->...ij", wy, mask.float(), wx)


# --------------------------------------------------------------------------
# Full per-batch pass


def average_recall(gt_boxes, gt_valid, prop_boxes, prop_valid) -> torch.Tensor:
    """AR = 2 * mean over valid GTs of max(best IoU - 0.5, 0) -> [B]."""
    iou = box_ops.box_iou_masked(gt_boxes, gt_valid, prop_boxes, prop_valid)
    vals = (iou.amax(-1) - 0.5).clamp(min=0.0) * gt_valid
    return 2.0 * vals.sum(-1) / gt_valid.sum(-1).clamp(min=1)


def harvest_trunk(params, online_rpn: Optional[OnlineRPNModels], anchors: torch.Tensor,
                  images: torch.Tensor, image_sizes: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, dcfg: DetectorConfig = DetectorConfig(),
                  with_mask_features: bool = True):
    """The CNN half of harvesting for a canvas batch: backbone (B2) -> RPN
    conv -> proposals -> RoIAlign of GT ++ proposals (B4) -> res5.
    Returns (t [B, h, w, 1024] f32, prop_boxes [B, R, 4], prop_valid,
    feats [B, G+R, 2048] f32, deconv [B, G, 14, 14, 256] or None).

    The trunk runs in ``dcfg``'s compute dtype; what the sampling stages see
    is cast back to f32, as in the JAX package."""
    dev = images.device
    with annotate("trunk.backbone"):
        x = normalize_canvas(images).to(resolve_compute_dtype(dcfg, dev))
        c4 = resnet.backbone_c4(params.backbone, x)
    with annotate("trunk.propose"):
        t = rpn_features(params.rpn, c4)
        scores, deltas = rpn_scores_deltas(params.rpn, online_rpn, t)
        prop_boxes, _, prop_valid = propose(
            scores, deltas, anchors, image_sizes.float(),
            pre_nms_top_n=dcfg.pre_nms_top_n, post_nms_top_n=dcfg.post_nms_top_n,
            nms_thresh=dcfg.rpn_nms_thresh, min_size=dcfg.rpn_min_size)

    with annotate("trunk.roi"):
        b, g = gt_boxes.shape[:2]
        p = dcfg.pooler_resolution
        all_boxes = torch.cat([gt_boxes.float(), prop_boxes], dim=1)
        pooled = roi_align_fused2(c4, all_boxes, p, dcfg.pooler_scale)  # [B, G+R, P, P, C]
        r = pooled.shape[1]
        flat = pooled.reshape((b * r,) + pooled.shape[2:])
        feats = resnet.res5_feature_map(params.backbone, flat).float().mean(dim=(1, 2))
        deconv = None
        if with_mask_features:
            # res5 again on the G GT rows only, as in the JAX package
            gt_rows = pooled[:, :g].reshape((b * g,) + pooled.shape[2:])
            deconv = mask_deconv(params.mask_head,
                                 resnet.res5_feature_map(params.backbone, gt_rows))
            deconv = deconv.reshape((b, g) + deconv.shape[1:])
    return t.float(), prop_boxes, prop_valid, feats.reshape(b, r, -1), deconv


def harvest_chunks(t, prop_boxes, prop_valid, feats, deconv, anchors, visibility,
                   image_sizes, gt_boxes, gt_labels, gt_valid,
                   gt_masks_14: Optional[torch.Tensor], hcfg: HarvestConfig,
                   with_rpn: bool = True, generator=None) -> HarvestChunk:
    """The sampling half for a canvas batch: anchor matching and the per-head
    chunk extraction."""
    rpn_chunk = None
    if with_rpn:
        rpn_chunk = harvest_rpn(t, anchors, visibility, gt_boxes, gt_valid, hcfg, generator)
    ar = average_recall(gt_boxes, gt_valid, prop_boxes, prop_valid)
    all_boxes = torch.cat([gt_boxes, prop_boxes], dim=1)
    rows_valid = torch.cat([gt_valid, prop_valid], dim=1)
    det_chunk = harvest_detector(feats, all_boxes, rows_valid, gt_labels, gt_valid,
                                 image_sizes, hcfg, generator)
    mask_chunk = None
    if gt_masks_14 is not None and deconv is not None:
        mask_chunk = harvest_mask(deconv, gt_masks_14, gt_labels, gt_valid, hcfg, generator)
    return HarvestChunk(rpn_chunk, det_chunk, mask_chunk, ar)


def first_image(chunk: HarvestChunk) -> HarvestChunk:
    """A canvas batch's chunk -> its first image's chunk (batch axis gone)."""
    def take(part):
        return None if part is None else type(part)(*(x[0] for x in part))

    return HarvestChunk(take(chunk.rpn), take(chunk.det), take(chunk.mask),
                        chunk.average_recall[0])


def harvest_image(params, online_rpn: Optional[OnlineRPNModels], anchors: torch.Tensor,
                  visibility: torch.Tensor, image: torch.Tensor, image_size: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                  gt_masks: Optional[torch.Tensor], hcfg: HarvestConfig,
                  dcfg: DetectorConfig = DetectorConfig(), with_rpn: bool = True,
                  generator=None) -> HarvestChunk:
    """One image's harvesting pass: the batched trunk and chunks at B = 1.
    image [H, W, 3] canvas, image_size (width, height), gt_* [G, ...],
    gt_masks [G, H, W] at canvas resolution (projected on the device here)
    or None. Returns the image's chunk with no batch axis."""
    one = lambda t: t[None]
    trunk = harvest_trunk(params, online_rpn, anchors, one(image), one(image_size),
                          one(gt_boxes), one(gt_valid), dcfg,
                          with_mask_features=gt_masks is not None)
    gm14 = None if gt_masks is None else one(project_mask_on_box(gt_masks, gt_boxes, 14))
    return first_image(harvest_chunks(*trunk, anchors, one(visibility), one(image_size),
                                      one(gt_boxes), one(gt_labels), one(gt_valid), gm14, hcfg,
                                      with_rpn, generator))
