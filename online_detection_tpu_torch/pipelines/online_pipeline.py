"""On-line training configuration, the result.txt contract and the test
loop with its VOC scoring (counterpart of the parts of
``pipelines/online_pipeline.py`` that the device route uses).

``run_inference`` is the flagship's inference stage: canvases in batches
through ``detect_batched`` on the card, one device-to-host copy of the
detections and masks a batch, predictions in image coordinates, then
``voc_eval.evaluate`` on the host.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from online_detection_tpu_torch.data import transforms
from online_detection_tpu_torch.data.datasets import harvest_annotation
from online_detection_tpu_torch.data.evaluation import voc_eval
from online_detection_tpu_torch.data.loader import CanvasLoader
from online_detection_tpu_torch.models.anchors import grid_anchors
from online_detection_tpu_torch.models.detector import (
    DetectorConfig,
    OnlineModelSet,
    detect_batched,
)
from online_detection_tpu_torch.utils.device import resolve_device
from online_detection_tpu_torch.utils.telemetry import (
    Timer,
    profile_trace,
    setup_logger,
    teardown_logger,
)


class OnlineTrainConfig(NamedTuple):
    """Hyperparameters of the on-line modules; defaults are the flagship
    configuration (``config_online_rpn_detection_segmentation_ycbv.yaml`` with
    its feature-extraction config)."""

    num_classes: int = 21
    num_anchor_classes: int = 15
    # FALKON (sigma, lambda, M)
    det_sigma: float = 15.0
    det_lam: float = 1e-5
    det_m: int = 1000
    rpn_sigma: float = 50.0
    rpn_lam: float = 1e-3
    rpn_m: int = 1000
    segm_sigma: float = 10.0
    segm_lam: float = 1e-6
    segm_m: int = 500
    # RLS
    det_reg_lam: float = 1000.0
    rpn_reg_lam: float = 0.01
    # minibootstrap
    iterations: int = 10
    batch_size: int = 2000
    hard_thresh: float = -0.7
    easy_thresh: float = -0.9
    # misc
    pos_fraction_feat_stats: float = 0.8
    use_only_gt_positives_detection: bool = False
    # fraction of the COXY rows used as classifier positives when
    # use_only_gt_positives_detection is off
    sampling_ratio_positives_detection: float = 1.0
    normalize_features_regressor_detector: bool = False
    segm_batch_size: int = 20000
    with_rpn: bool = True
    with_segmentation: bool = True
    # SHUFFLE_NEGATIVES: True -> negative pools shuffled, then split into
    # batches; False -> the round-robin deal of the arrival order
    shuffle_negatives: bool = False
    rpn_shuffle_negatives: bool = False
    # reservoir capacities: per-class positives and the shared COXY rows kept
    rpn_pos_cap: int = 4096
    det_pos_cap: int = 2048
    coxy_cap: int = 30000
    segm_pos_cap: int = 8192  # positive pixels kept per class
    # classes trained at once by the minibootstrap solver
    solver_class_chunk: int = 8


def _write_result(output_dir: Optional[str], text: str):
    """Append ``text`` to ``output_dir/result.txt`` (nothing without a dir)."""
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "result.txt"), "a") as fid:
            fid.write(text)


def _to_host(dets, masks):
    """Detections [B, D] (and masks [B, D, P, P]) -> numpy, in one
    device-to-host copy: the fields are packed into one f32 tensor
    [B, D, 7 (+ P*P)] on the device first (labels and validity are small
    integers, exact in f32)."""
    b, d = dets.scores.shape
    cols = [dets.boxes, dets.scores[..., None], dets.labels[..., None].float(),
            dets.valid[..., None].float()]
    if masks is not None:
        cols.append(masks.reshape(b, d, -1).float())
    packed = torch.cat(cols, -1).cpu().numpy()
    boxes, scores = packed[..., :4], packed[..., 4]
    labels, valid = packed[..., 5].astype(np.int32), packed[..., 6] > 0.5
    mask_np = None if masks is None else packed[..., 7:].reshape(masks.shape)
    return boxes, scores, labels, valid, mask_np


def run_inference(
    params,
    online: OnlineModelSet,
    dataset,
    canvas_hw: Tuple[int, int],
    dcfg: DetectorConfig = DetectorConfig(),
    with_masks: bool = True,
    output_dir: Optional[str] = None,
    iou_thresholds=(0.5,),
    use_07_metric: bool = True,
    min_size: int = 600,
    max_size: int = 1333,
    eval_segm_with_gt_bboxes: bool = False,
    gt_cap: int = 20,
    batch_size: int = 1,
    device=None,
):
    """Test loop + VOC evaluation (``engine/inference.py:266-353`` +
    evaluation dispatch). Returns (results dict, predictions).

    ``dataset`` has ``__len__``, ``classes``, ``load_image(i)``,
    ``get_annotation(i)`` (``boxes``, 1-based ``labels``, ``difficult``) and,
    with masks, ``load_masks(i, anno)``. ``device`` defaults to the card;
    ``params`` and ``online`` must already live there.
    ``eval_segm_with_gt_bboxes`` substitutes GT boxes for the detections
    before the mask head (mask-quality-only protocol, ``roi_heads.py:32-37``).
    ``batch_size`` stacks canvases into one ``detect_batched`` call (the
    reference is hard-wired batch 1); the tail batch is padded with its last
    image and the padding's results are dropped. The JAX package's
    ``roi_chunk`` switch at large batches has no counterpart: it bounds an
    XLA RoIAlign intermediate, and the port's RoIAlign kernel keeps none.
    """
    dev = resolve_device(device)
    ch, cw = canvas_hw
    anchors = torch.from_numpy(grid_anchors(ch // 16, cw // 16)).to(dev)
    with_masks = with_masks and online.mask is not None
    b = max(1, batch_size)

    logger = setup_logger("online_detection_tpu_torch.inference", output_dir)
    logger.info(
        "Start evaluation on %d images (masks=%s, gt_bboxes=%s, batch=%d)",
        len(dataset), with_masks, eval_segm_with_gt_bboxes, b,
    )
    inference_timer = Timer()
    loader_ctx = CanvasLoader(dataset, canvas_hw, min_size, max_size)
    trace_ctx = profile_trace(os.environ.get("ODTPU_PROFILE_DIR"))

    n_images = len(dataset)
    predictions, ground_truths = [], []
    t0 = time.time()
    with loader_ctx as loader, trace_ctx:
        for lo in range(0, n_images, b):
            idxs = list(range(lo, min(lo + b, n_images)))
            annos = [dataset.get_annotation(i) for i in idxs]
            loaded = [loader.get(i) for i in idxs]
            while len(loaded) < b:  # pad the tail batch, results discarded
                loaded.append(loaded[-1])
                annos.append(annos[-1])
            canvases = torch.from_numpy(np.stack([c for c, _, _ in loaded])).to(dev)
            sizes = torch.tensor([swh for _, _, swh in loaded], dtype=torch.float32,
                                 device=dev)
            inference_timer.tic()
            gt = (None, None, None)
            if eval_segm_with_gt_bboxes:
                # the substituted boxes come from the engine-side GT parser
                # (harvest_annotation: -1-shifted for XML datasets), matching
                # the reference where compute_gts_* feeds the model while the
                # evaluator re-reads GT through the dataset class
                hannos = [harvest_annotation(dataset, i) for i in idxs]
                while len(hannos) < b:
                    hannos.append(hannos[-1])
                gbs = np.zeros((b, gt_cap, 4), np.float32)
                gls = np.zeros((b, gt_cap), np.int32)
                gvs = np.zeros((b, gt_cap), bool)
                for k, (anno, (_, scale, _)) in enumerate(zip(hannos, loaded)):
                    g = min(len(anno.boxes), gt_cap)
                    gbs[k, :g] = transforms.scale_boxes(anno.boxes, scale)[:g]
                    gls[k, :g] = anno.labels[:g]
                    gvs[k, :g] = True
                gt = tuple(torch.from_numpy(a).to(dev) for a in (gbs, gls, gvs))
            dets_b, mask_b, _, _ = detect_batched(params, online, anchors, canvases, sizes,
                                                  dcfg, with_masks, *gt, device=dev)
            boxes_b, scores_b, labels_b, valid_b, mask_b = _to_host(
                dets_b, mask_b if with_masks else None)
            inference_timer.toc()
            for k, i in enumerate(idxs):
                anno = annos[k]
                scale = loaded[k][1]
                v = valid_b[k]
                pred = {
                    "boxes": boxes_b[k][v] / scale,  # original coords
                    "scores": scores_b[k][v],
                    "labels": labels_b[k][v],
                }
                if mask_b is not None:
                    pred["masks"] = mask_b[k][v]
                predictions.append(pred)
                gt_i = {
                    "boxes": anno.boxes,
                    "labels": anno.labels,
                    "difficult": anno.difficult,
                }
                if with_masks:
                    gt_i["masks"] = dataset.load_masks(i, anno)
                ground_truths.append(gt_i)
    test_time = time.time() - t0
    logger.info(
        "inference done: %.1fs total, %.4fs/img device (%.4fs/img wall)",
        test_time, inference_timer.average_time,
        test_time / max(len(dataset), 1),
    )
    teardown_logger("online_detection_tpu_torch.inference")
    _write_result(
        output_dir,
        "Average image testing time: {:.4f} seconds.\n".format(
            test_time / max(len(dataset), 1)
        ),
    )

    results = voc_eval.evaluate(
        predictions,
        ground_truths,
        dataset.classes,
        iou_thresholds=iou_thresholds,
        use_07_metric=use_07_metric,
        evaluate_segmentation=with_masks,
        output_dir=output_dir,
    )
    return results, predictions
