"""On-line segmentation demo and incremental teaching (counterpart of
``modules/demo.py``).

Rebuilds ``mrcnn_modified/demo/predictor_online_segmentation.py`` (the
``OnlineSegmentationDemo``) and the incremental-training hooks
(``DEMO.INCREMENTAL_TRAIN``, ``box_head_getProposals.py:90-99
add_new_class``):

- ``OnlineSegmentationDemo``: the per-image predictor: preprocess,
  ``detect_batched`` at B = 1 (kernels B1, B2 and B3 on the card), mask
  pasting on the host, and an overlay renderer (a numpy blend, no cv2).
- ``IncrementalTeacher``: the robot-teaching loop: feed (image, GT box,
  label, mask) observations one at a time, ``add_new_class`` to grow the
  class set, ``update_model`` to re-harvest every observation
  (``harvest_image``: B2, and B4 as its RoIAlign) into a
  ``HarvestAccumulator`` and retrain every on-line module
  (``train_online_modules``: B1 in the solvers).

Both run on ``device`` (the card by default; on a host without one they
raise unless given ``device="cpu"``); the network and the on-line models
are moved there. The teacher's draws come from a CPU ``torch.Generator``
seeded with ``seed``, where the JAX package splits ``jax.random.key(seed)``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from online_detection_tpu_torch.data import transforms
from online_detection_tpu_torch.data.evaluation.voc_eval import paste_mask
from online_detection_tpu_torch.engine.accumulate import HarvestAccumulator
from online_detection_tpu_torch.engine.harvest import HarvestConfig, harvest_image
from online_detection_tpu_torch.models.anchors import anchor_visibility, grid_anchors
from online_detection_tpu_torch.models.detector import (
    DetectorConfig,
    OnlineModelSet,
    detect_batched,
)
from online_detection_tpu_torch.pipelines.online_pipeline import (
    OnlineTrainConfig,
    train_online_modules,
)
from online_detection_tpu_torch.utils.device import host_array, ieee_fp32, resolve_device

PALETTE = [
    (255, 99, 71), (60, 179, 113), (65, 105, 225), (255, 215, 0),
    (186, 85, 211), (0, 206, 209), (255, 140, 0), (154, 205, 50),
]


class OnlineSegmentationDemo:
    """Per-image predictor over trained on-line modules."""

    def __init__(
        self,
        params,
        online: OnlineModelSet,
        class_names: Sequence[str],
        canvas_hw: Tuple[int, int] = (608, 800),
        det_cfg: DetectorConfig = DetectorConfig(),
        min_size: int = 600,
        max_size: int = 1333,
        confidence_threshold: float = 0.0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.online = online.to(self.device)
        self.class_names = list(class_names)
        self.canvas_hw = canvas_hw
        self.det_cfg = det_cfg
        self.min_size = min_size
        self.max_size = max_size
        self.confidence_threshold = confidence_threshold
        ch, cw = canvas_hw
        self.anchors = torch.from_numpy(grid_anchors(ch // 16, cw // 16)).to(self.device)

    def run_on_image(self, rgb: np.ndarray) -> Dict:
        """rgb [H, W, 3] uint8 -> {boxes, scores, labels, class_names, masks
        (full-resolution uint8)} in the original image's coordinates."""
        h, w = rgb.shape[:2]
        canvas, scale, (sw, sh) = transforms.preprocess_image_u8(
            rgb, self.canvas_hw, self.min_size, self.max_size)
        dev = self.device
        dets, mask_probs, _, _ = detect_batched(
            self.params, self.online, self.anchors, torch.from_numpy(canvas[None]).to(dev),
            torch.tensor([[sw, sh]], dtype=torch.float32, device=dev), self.det_cfg,
            with_masks=self.online.mask is not None, device=dev)
        valid, scores = host_array(dets.valid[0]), host_array(dets.scores[0])
        keep = valid & (scores >= self.confidence_threshold)
        boxes = host_array(dets.boxes[0])[keep] / scale
        labels = host_array(dets.labels[0])[keep]
        out = {
            "boxes": boxes,
            "scores": scores[keep],
            "labels": labels,
            "class_names": [
                self.class_names[int(lb)] if int(lb) < len(self.class_names) else str(lb)
                for lb in labels
            ],
        }
        if mask_probs is not None:
            probs = host_array(mask_probs[0])[keep]
            out["masks"] = np.stack(
                [paste_mask(m, b, h, w) for m, b in zip(probs, boxes)]
            ) if len(probs) else np.zeros((0, h, w), np.uint8)
        return out

    def overlay(self, rgb: np.ndarray, result: Optional[Dict] = None) -> np.ndarray:
        """Renders boxes and masks onto the image (the reference's cv2
        overlay, as a numpy blend)."""
        result = result or self.run_on_image(rgb)
        img = rgb.astype(np.float32).copy()
        masks = result.get("masks")
        for i, box in enumerate(result["boxes"]):
            color = np.asarray(PALETTE[i % len(PALETTE)], np.float32)
            if masks is not None and i < len(masks):
                m = masks[i].astype(bool)
                img[m] = 0.5 * img[m] + 0.5 * color
            x1, y1, x2, y2 = [int(round(v)) for v in box]
            x1, y1 = max(x1, 0), max(y1, 0)
            x2, y2 = min(x2, img.shape[1] - 1), min(y2, img.shape[0] - 1)
            img[y1 : y1 + 2, x1:x2] = color
            img[y2 - 1 : y2 + 1, x1:x2] = color
            img[y1:y2, x1 : x1 + 2] = color
            img[y1:y2, x2 - 1 : x2 + 1] = color
        return img.astype(np.uint8)


class IncrementalTeacher:
    """Robot-teaching loop with incremental class addition.

    Mirrors the reference's ``DEMO.INCREMENTAL_TRAIN`` machinery: the
    observations are kept, so ``update_model`` can retrain at any time, and
    ``add_new_class`` extends the label set without showing the old classes
    again (``rpn_getProposals.py:168,250-252``,
    ``box_head_getProposals.py:90-99``)."""

    def __init__(
        self,
        params,
        class_names: Optional[List[str]] = None,
        canvas_hw: Tuple[int, int] = (608, 800),
        train_cfg: OnlineTrainConfig = OnlineTrainConfig(num_classes=0, iterations=2,
                                                         batch_size=500),
        det_cfg: DetectorConfig = DetectorConfig(),
        min_size: int = 600,
        max_size: int = 1333,
        gt_cap: int = 4,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.class_names = class_names or ["__background__"]
        self.canvas_hw = canvas_hw
        self.train_cfg = train_cfg
        self.det_cfg = det_cfg
        self.min_size = min_size
        self.max_size = max_size
        self.gt_cap = gt_cap
        self._observations: List[Dict] = []
        self.generator = torch.Generator().manual_seed(seed)

    @property
    def num_classes(self) -> int:
        return len(self.class_names) - 1

    def add_new_class(self, name: str) -> int:
        """Registers a new object class; returns its 1-based label."""
        self.class_names.append(name)
        return len(self.class_names) - 1

    def observe(self, rgb: np.ndarray, box_xyxy, label: int,
                mask: Optional[np.ndarray] = None):
        """Records one teaching observation (image, GT box, and a mask or None)."""
        self._observations.append(
            {"rgb": rgb, "box": np.asarray(box_xyxy, np.float32), "label": int(label),
             "mask": mask})

    @ieee_fp32()
    @torch.inference_mode()
    def update_model(self, output_dir: Optional[str] = None) -> OnlineModelSet:
        """Re-harvests every observation and retrains every on-line module at
        the current class count."""
        cfg = self.train_cfg._replace(
            num_classes=max(self.num_classes, 1),
            with_segmentation=any(o["mask"] is not None for o in self._observations),
        )
        n = max(len(self._observations), 1)
        npick = int(np.ceil(cfg.batch_size * cfg.iterations / n))
        hcfg = HarvestConfig(num_anchor_classes=cfg.num_anchor_classes,
                             num_classes=cfg.num_classes, negatives_to_pick=npick,
                             gt_cap=self.gt_cap)
        dev = self.device
        ch, cw = self.canvas_hw
        anchors_np = grid_anchors(ch // 16, cw // 16)
        anchors = torch.from_numpy(anchors_np).to(dev)
        acc = HarvestAccumulator(cfg.num_anchor_classes, cfg.num_classes)
        for obs in self._observations:
            canvas, scale, (sw, sh) = transforms.preprocess_image(
                obs["rgb"], self.canvas_hw, self.min_size, self.max_size)
            gb = np.zeros((self.gt_cap, 4), np.float32)
            gb[0] = obs["box"] * scale
            gl = np.zeros((self.gt_cap,), np.int64)
            gl[0] = obs["label"]
            gv = np.arange(self.gt_cap) < 1
            gm = None
            if cfg.with_segmentation and obs["mask"] is not None:
                # nearest resize of the mask onto the canvas (demo.py:216-222)
                gm = np.zeros((self.gt_cap, ch, cw), np.float32)
                m = obs["mask"]
                ys = np.clip((np.arange(ch) / scale).astype(int), 0, m.shape[0] - 1)
                xs = np.clip((np.arange(cw) / scale).astype(int), 0, m.shape[1] - 1)
                gm[0] = m[np.ix_(ys, xs)]
                gm = torch.from_numpy(gm).to(dev)
            vis = anchor_visibility(anchors_np, (sw, sh))
            t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
            chunk = harvest_image(self.params, None, anchors, t(vis), t(canvas),
                                  t(np.array([sw, sh])), t(gb), t(gl), t(gv), gm, hcfg,
                                  self.det_cfg, generator=self.generator)
            acc.add(chunk)
        harvest = acc.finalize(
            rpn_iterations=cfg.iterations, rpn_batch_size=cfg.batch_size,
            det_iterations=cfg.iterations, det_batch_size=cfg.batch_size,
            segm_batch_size=cfg.segm_batch_size,
            with_rpn=cfg.with_rpn, with_mask=cfg.with_segmentation,
            negatives_to_pick=npick,
        )
        return train_online_modules(self.generator, harvest, cfg, output_dir, device=dev)
