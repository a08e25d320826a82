"""End-to-end on-line training on its host route, and evaluation
(counterpart of ``pipelines/online_pipeline.py``).

The host route, which the flagship CLI takes when it saves or loads feature
caches and on the CPU:

1. ``harvest_dataset``: one image at a time through the frozen network on
   the device (``harvest_trunk`` + ``harvest_chunks`` at B = 1), each
   image's chunk copied to the host in one packed copy and folded into the
   host reservoirs (``HarvestAccumulator``), then ``finalize`` into the
   solver-shaped arrays;
2. ``train_online_modules``: per head, the feature statistics on the host
   (NumPy, the JAX package's draws), the pools uploaded once, then the
   minibootstrap FALKON classifiers (all classes in one chunk) and the RLS
   refiners on the device. The COXY rows are grouped by class on the device.

The stages write the reference's ``result.txt`` lines in its order. The
solvers run with TF32 off (``utils.device.ieee_fp32``).

``run_inference`` is the flagship's inference stage: canvases in batches
through ``detect_batched`` on the card, one device-to-host copy of the
detections and masks a batch, predictions in image coordinates, then
``voc_eval.evaluate`` on the host.

With a ``mesh`` (``parallel/mesh.py``) the training stages split each head's
classes over its devices, and ``run_inference`` each canvas batch.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import math
import os
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from online_detection_tpu_torch.data import transforms
from online_detection_tpu_torch.data.datasets import harvest_annotation
from online_detection_tpu_torch.data.evaluation import voc_eval
from online_detection_tpu_torch.data.loader import CanvasLoader
from online_detection_tpu_torch.data.mask_project import project_masks_for_image
from online_detection_tpu_torch.engine.accumulate import HarvestAccumulator
from online_detection_tpu_torch.engine.harvest import (
    HarvestConfig,
    first_image,
    harvest_chunks,
    harvest_trunk,
)
from online_detection_tpu_torch.models.anchors import anchor_visibility, grid_anchors
from online_detection_tpu_torch.models.detector import (
    DetectorConfig,
    OnlineModelSet,
    detect_batched,
)
from online_detection_tpu_torch.models.heads import OnlineDetectorModels, OnlineMaskModels
from online_detection_tpu_torch.models.rpn import OnlineRPNModels
from online_detection_tpu_torch.solvers.minibootstrap import (
    MinibootstrapParams,
    train_classifiers_minibootstrap,
)
from online_detection_tpu_torch.solvers.rls import RLSModel, rls_fit
from online_detection_tpu_torch.utils.device import (
    host_array,
    ieee_fp32,
    resolve_device,
    sync,
    to_device,
)
from online_detection_tpu_torch.utils.stats import FeatureStats, compute_feature_stats, zscore
from online_detection_tpu_torch.utils.telemetry import (
    Timer,
    annotate,
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


_LOG = logging.getLogger("online_detection_tpu_torch.harvest")


def _fmt(sec: float) -> str:
    return "{}min:{}s".format(int(sec / 60), round(sec % 60))


def _entry_device(device, mesh) -> torch.device:
    """An entry point's device: ``device``, or the mesh's first device (which
    ``device``, when given, must match in type)."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and torch.device(device).type != mesh.first.type:
        raise ValueError(f"device {device} is not the mesh's first device {mesh.first}")
    return resolve_device(mesh.first)


class _StageClock:
    """Stage clocks of both training routes (``with clock.stage(name,
    line):``): a stage starts after a device sync (queued work such as the
    feature statistics ends first, so a clock spans what the JAX package's
    spans) and ends after one, inside the span ``train.<name>``; its seconds
    go into ``timings`` under its name, and ``line``, formatted with them,
    into ``output_dir/result.txt``. A stage that raises records nothing."""

    def __init__(self, dev: torch.device, timings: Optional[Dict[str, float]],
                 output_dir: Optional[str] = None):
        self.dev = dev
        self.timings = {} if timings is None else timings
        self.output_dir = output_dir

    @contextlib.contextmanager
    def stage(self, name: str, line: str):
        sync(self.dev)
        with annotate("train." + name):
            t0 = time.time()
            yield
            sync(self.dev)
            self.timings[name] = time.time() - t0
        mem = torch.cuda.memory_allocated(self.dev) / 2**20 if self.dev.type == "cuda" else 0.0
        _LOG.info("%s: %.3f s, %.0f MB allocated", name, self.timings[name], mem)
        _write_result(self.output_dir, line.format(_fmt(self.timings[name])))


def _head_stats(head: Dict, rng: np.random.Generator, pos_fraction: float,
                dev: torch.device) -> FeatureStats:
    return compute_feature_stats(rng, head["pos"], head["pos_valid"], head["neg"],
                                 head["neg_valid"], pos_fraction=pos_fraction).to(dev)


def _class_blocks(cls: np.ndarray, num_classes: int, rows_of=None):
    """Row indices of each class (0-based labels ``cls``), in row order,
    padded to the largest class: (index [C, cap] int64, valid [C, cap]).
    ``rows_of(c, rows)`` may thin a class's rows."""
    per_class = []
    for c in range(num_classes):
        rows = np.nonzero(cls == c)[0]
        per_class.append(rows if rows_of is None else rows_of(c, rows))
    cap = max(1, max((len(r) for r in per_class), default=1))
    index = np.zeros((num_classes, cap), np.int64)
    valid = np.zeros((num_classes, cap), bool)
    for c, rows in enumerate(per_class):
        index[c, :len(rows)] = rows
        valid[c, :len(rows)] = True
    return index, valid


def _gather_blocks(x: torch.Tensor, index: np.ndarray, valid: np.ndarray) -> torch.Tensor:
    """x [N, d] on its device -> [C, cap, d] blocks, zero where not valid,
    in one gather."""
    dev = x.device
    v = torch.from_numpy(valid).to(dev)
    if x.shape[0] == 0:
        return x.new_zeros(valid.shape + (x.shape[1],))
    blocks = x[torch.from_numpy(index).to(dev)]
    return torch.where(v[..., None], blocks, torch.zeros((), dtype=x.dtype, device=dev))


def _positives_from_coxy(coxy: Dict, num_classes: int, samples_fraction: float = 1.0,
                         rng: Optional[np.random.Generator] = None, device="cpu"):
    """``load_positives_from_COXY`` (``py_od_utils.py:226-239``): per class,
    the COXY rows labelled with that class become classifier positives;
    ``samples_fraction < 1`` keeps a random subset without replacement
    (``randperm[:int(n*frac)]``, the JAX package's NumPy draws). The rows'
    indices are found on the host and the rows gathered on ``device`` in
    one go -> (pos [C, cap, d], valid [C, cap])."""
    rng = rng if rng is not None else np.random.default_rng(0)

    def thin(c, rows):
        if samples_fraction < 1.0 and len(rows):
            return rows[rng.permutation(len(rows))[: int(len(rows) * samples_fraction)]]
        return rows

    cls = host_array(coxy["C"]).astype(int) - 1
    index, valid = _class_blocks(cls, num_classes, thin)
    x = to_device(coxy["X"], torch.device(device))
    return _gather_blocks(x, index, valid), torch.from_numpy(valid).to(x.device)


def _fit_rls_per_class(x: torch.Tensor, y, c, num_classes: int, lam: float,
                       zero_based: bool) -> RLSModel:
    """Groups the COXY rows x [N, d] (on their device) by class into blocks
    padded to the largest class, then fits the batched RLS refiners (device
    Gram pass, host float64 solves)."""
    cls = host_array(c).astype(int)
    if not zero_based:
        cls = cls - 1
    index, valid = _class_blocks(cls, num_classes)
    dev = x.device
    if x.shape[0] == 0:
        x = x.new_zeros((0, 1))
    y = to_device(host_array(y).astype(np.float32, copy=False).reshape(-1, 4), dev)
    yb = _gather_blocks(y, index, valid)
    w = torch.from_numpy(valid).to(dev).float()
    return rls_fit(_gather_blocks(x, index, valid), yb, w, lam)


@ieee_fp32()
@torch.inference_mode()
def harvest_dataset(generator: Optional[torch.Generator], params, dataset,
                    cfg: OnlineTrainConfig, canvas_hw: Tuple[int, int],
                    online_rpn: Optional[OnlineRPNModels] = None,
                    dcfg: DetectorConfig = DetectorConfig(), gt_cap: int = 20,
                    output_dir: Optional[str] = None, min_size: int = 600,
                    max_size: int = 1333, device=None, prefetch: Optional[str] = None) -> Dict:
    """One streaming pass over ``dataset`` -> solver-ready host arrays (the
    ``finalize`` dict of ``HarvestAccumulator``, plus ``extraction_time``,
    ``finalize_time`` and ``host_bytes``, what the per-image copies moved).

    Each image runs through the network at B = 1 on ``device`` (the card by
    default; ``params`` and ``online_rpn`` must live there), with draws from
    ``generator``. ``dataset`` has ``__len__``, ``load_image(i)``, an
    annotation (``harvest_annotation(i)`` or ``get_annotation(i)``) and, for
    the segmentation head, ``load_masks(i, anno)``. ``prefetch``: the
    ``CanvasLoader`` mode (None, "threads" or "native")."""
    dev = resolve_device(device)
    if params.rpn.conv_w.device.type != dev.type:
        raise ValueError(f"params are on {params.rpn.conv_w.device}; move them to {dev}")
    t0 = time.time()
    n_images = len(dataset)
    npick = math.ceil(cfg.batch_size * cfg.iterations / max(n_images, 1))
    hcfg = HarvestConfig(num_anchor_classes=cfg.num_anchor_classes,
                         num_classes=cfg.num_classes, negatives_to_pick=npick, gt_cap=gt_cap)
    ch, cw = canvas_hw
    anchors_np = grid_anchors(ch // 16, cw // 16)
    anchors = torch.from_numpy(anchors_np).to(dev)

    acc = HarvestAccumulator(cfg.num_anchor_classes, cfg.num_classes)
    with CanvasLoader(dataset, canvas_hw, min_size, max_size, prefetch=prefetch) as loader:
        for i in range(n_images):
            anno = harvest_annotation(dataset, i)
            canvas, scale, (sw, sh) = loader.get(i)
            boxes = transforms.scale_boxes(np.asarray(anno.boxes, np.float32), scale)
            g = len(boxes)
            gb = np.zeros((gt_cap, 4), np.float32)
            gb[:g] = boxes[:gt_cap]
            gl = np.zeros((gt_cap,), np.int64)
            gl[:g] = np.asarray(anno.labels)[:gt_cap]
            gv = np.arange(gt_cap) < g
            gm = None
            if cfg.with_segmentation:
                gm = to_device(project_masks_for_image(dataset.load_masks(i, anno), gb[:g],
                                                       scale, gt_cap)[None], dev)
            vis = to_device(anchor_visibility(anchors_np, (sw, sh))[None], dev)
            size = to_device(np.asarray([[sw, sh]], np.int64), dev)
            gb_t, gl_t, gv_t = (to_device(a[None], dev) for a in (gb, gl, gv))
            trunk = harvest_trunk(params, online_rpn, anchors, to_device(canvas[None], dev),
                                  size, gb_t, gv_t, dcfg, cfg.with_segmentation)
            chunk = harvest_chunks(*trunk, anchors, vis, size, gb_t, gl_t, gv_t, gm, hcfg,
                                   cfg.with_rpn, generator)
            acc.add(first_image(chunk))

    t_fin = time.time()
    out = acc.finalize(
        rpn_iterations=cfg.iterations, rpn_batch_size=cfg.batch_size,
        det_iterations=cfg.iterations, det_batch_size=cfg.batch_size,
        segm_batch_size=cfg.segm_batch_size,
        shuffle_negatives=cfg.shuffle_negatives,
        rpn_shuffle_negatives=cfg.rpn_shuffle_negatives,
        with_rpn=cfg.with_rpn, with_mask=cfg.with_segmentation,
        negatives_to_pick=npick,
    )
    out["finalize_time"] = time.time() - t_fin
    out["host_bytes"] = acc.host_bytes
    del acc
    dt = time.time() - t0
    _write_result(output_dir, "Detector's features extracted in: {} \n".format(_fmt(dt)))
    # AR over the harvested stream (``feature_proposal_extractor.py:308-313``)
    _write_result(output_dir, "Average Recall (AR): {} \n \n".format(out["average_recall"]))
    # never truncate silently: report rows lost to any fixed cap
    trunc = out.get("truncation", {})
    if trunc.get("total", 0) > 0:
        _LOG.warning("fixed-capacity truncation during harvest: %s", trunc)
        _write_result(output_dir, "truncated: {} \n".format(trunc))
    out["extraction_time"] = dt
    return out


def _pools(head: Dict, dev: torch.device):
    """The head's pools on ``dev``: one copy each, straight from the host
    arrays (pageable, GB-sized, copied once)."""
    return tuple(torch.as_tensor(head[k]).to(dev) for k in ("pos", "pos_valid", "neg",
                                                             "neg_valid"))


def _minibootstrap(head: Dict, dev, stats: FeatureStats, m: int, sigma: float, lam: float,
                   cfg: OnlineTrainConfig, generator, mesh=None):
    """All classes of a head in one chunk, as the JAX package's host route
    trains them (split over ``mesh``'s devices with one); the pools are
    z-scored inside the solver's cache. Every class's draws are made up
    front, in class order (``train_classifiers_minibootstrap``)."""
    params = MinibootstrapParams(m=m, sigma=sigma, lam=lam, hard_thresh=cfg.hard_thresh,
                                 easy_thresh=cfg.easy_thresh)
    return train_classifiers_minibootstrap(*_pools(head, dev), params, stats=stats,
                                           generator=generator, mesh=mesh)


@ieee_fp32()
@torch.inference_mode()
def train_rpn_module(generator: Optional[torch.Generator], rpn: Dict, cfg: OnlineTrainConfig,
                     output_dir: Optional[str] = None, seed: int = 0, mesh=None, device=None,
                     timings: Optional[Dict[str, float]] = None) -> OnlineRPNModels:
    """Stage 2: per-anchor FALKON classifiers + RLS refiners of the O-RPN.
    ``mesh``: the anchor classes are split over its devices, whose first
    must be ``device``."""
    dev = _entry_device(device, mesh)
    clock = _StageClock(dev, timings, output_dir)
    rng = np.random.default_rng(seed)
    stats_rpn = _head_stats(rpn, rng, cfg.pos_fraction_feat_stats, dev)
    with clock.stage("rpn_falkon", "RPN's Online Classifier training time: {} \n"):
        models = _minibootstrap(rpn, dev, stats_rpn, cfg.rpn_m, cfg.rpn_sigma, cfg.rpn_lam, cfg,
                                generator, mesh)
    # RPN refiners always train on z-scored COXY (run_..._oos.py:114)
    with clock.stage("rpn_rls", "RPN's Online Region Refiner training time: {} \n"):
        coxy = rpn["coxy"]
        cx = zscore(to_device(coxy["X"], dev), stats_rpn)
        rls = _fit_rls_per_class(cx, coxy["Y"], coxy["C"], cfg.num_anchor_classes,
                                 cfg.rpn_reg_lam, zero_based=True)
    return OnlineRPNModels(falkon=models, rls=rls, stats=stats_rpn)


@ieee_fp32()
@torch.inference_mode()
def train_detector_module(generator: Optional[torch.Generator], det: Dict,
                          cfg: OnlineTrainConfig, output_dir: Optional[str] = None,
                          seed: int = 0, mesh=None, device=None,
                          timings: Optional[Dict[str, float]] = None) -> OnlineDetectorModels:
    """Stage 3: RLS refiners, then per-class FALKON classifiers of the
    detector (split over ``mesh``'s devices with one)."""
    dev = _entry_device(device, mesh)
    clock = _StageClock(dev, timings, output_dir)
    rng = np.random.default_rng(seed)
    coxy = det["coxy"]
    coxy_x = to_device(coxy["X"], dev)
    if not cfg.use_only_gt_positives_detection and len(coxy_x):
        pos, pos_valid = _positives_from_coxy(
            dict(coxy, X=coxy_x), cfg.num_classes,
            samples_fraction=cfg.sampling_ratio_positives_detection, rng=rng, device=dev)
        det = dict(det, pos=pos, pos_valid=pos_valid)
    stats_det = _head_stats(det, rng, cfg.pos_fraction_feat_stats, dev)

    with clock.stage("det_rls", "Detector's Online Region Refiner training time: {} \n \n"):
        reg_x = zscore(coxy_x, stats_det) if cfg.normalize_features_regressor_detector \
            else coxy_x
        det_rls = _fit_rls_per_class(reg_x, coxy["Y"], coxy["C"], cfg.num_classes,
                                     cfg.det_reg_lam, zero_based=False)
    with clock.stage("det_falkon", "Detector's Online Classifier training time: {} \n"):
        det_falkon = _minibootstrap(det, dev, stats_det, cfg.det_m, cfg.det_sigma, cfg.det_lam,
                                    cfg, generator, mesh)
    return OnlineDetectorModels(falkon=det_falkon, rls=det_rls, stats=stats_det)


@ieee_fp32()
@torch.inference_mode()
def train_segmentation_module(generator: Optional[torch.Generator], seg: Dict,
                              cfg: OnlineTrainConfig, output_dir: Optional[str] = None,
                              seed: int = 0, mesh=None, device=None,
                              timings: Optional[Dict[str, float]] = None) -> OnlineMaskModels:
    """Stage 4: per-pixel FALKON classifiers of the segmentation head (split
    over ``mesh``'s devices with one)."""
    dev = _entry_device(device, mesh)
    clock = _StageClock(dev, timings, output_dir)
    rng = np.random.default_rng(seed)
    stats_seg = _head_stats(seg, rng, cfg.pos_fraction_feat_stats, dev)
    with clock.stage("segm_falkon", "Online Segmentation training time: {} \n"):
        seg_falkon = _minibootstrap(seg, dev, stats_seg, cfg.segm_m, cfg.segm_sigma,
                                    cfg.segm_lam, cfg, generator, mesh)
    return OnlineMaskModels(falkon=seg_falkon, stats=stats_seg)


def train_online_modules(generator: Optional[torch.Generator], harvest: Dict,
                         cfg: OnlineTrainConfig, output_dir: Optional[str] = None,
                         seed: int = 0, mesh=None, device=None,
                         timings: Optional[Dict[str, float]] = None) -> OnlineModelSet:
    """Stages 2-4 on ``device`` (the card by default) from the host arrays of
    ``harvest_dataset`` or ``load_features``; draws from ``generator``.
    ``timings``, when given, receives each stage's seconds (each clock
    starts and ends after a device sync). ``mesh``: each head's classes are
    split over its devices."""
    dev = _entry_device(device, mesh)
    kw = dict(output_dir=output_dir, seed=seed, device=dev, timings=timings, mesh=mesh)
    online_rpn = None
    if cfg.with_rpn and "rpn" in harvest:
        online_rpn = train_rpn_module(generator, harvest["rpn"], cfg, **kw)
    online_det = train_detector_module(generator, harvest["det"], cfg, **kw)
    online_mask = None
    if cfg.with_segmentation and "mask" in harvest:
        online_mask = train_segmentation_module(generator, harvest["mask"], cfg, **kw)
    return OnlineModelSet(rpn=online_rpn, detector=online_det, mask=online_mask)


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


def _sharded_detect(mesh, params, online: OnlineModelSet, anchors):
    """``detect_batched`` over a canvas batch split across ``mesh``: each
    device runs its slice with its replicas of the network and the models;
    the detections and masks are gathered on the mesh's first device."""

    def run(images, sizes, dcfg, with_masks, gt_boxes=None, gt_labels=None, gt_valid=None):
        def shard(im, sz, gb, gl, gv, p, o, a):
            return detect_batched(p, o, a, im, sz, dcfg, with_masks, gb, gl, gv,
                                  device=im.device)

        return mesh.map(shard, (images, sizes, gt_boxes, gt_labels, gt_valid),
                        (params, online, anchors))

    return run


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
    mesh=None,
    prefetch: Optional[str] = None,
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
    ``mesh``: the batch is rounded up to a mesh multiple, and each device
    runs ``detect_batched`` on its slice with its replica of the network and
    the models (the mesh's first device is ``device``). ``prefetch``: the
    ``CanvasLoader`` mode (None, "threads" or "native").
    """
    dev = _entry_device(device, mesh)
    ch, cw = canvas_hw
    anchors = torch.from_numpy(grid_anchors(ch // 16, cw // 16)).to(dev)
    with_masks = with_masks and online.mask is not None
    b = max(1, batch_size)
    detect = functools.partial(detect_batched, params, online, anchors, device=dev)
    if mesh is not None:
        b = -(-b // mesh.size) * mesh.size
        detect = _sharded_detect(mesh, params, online, anchors)

    logger = setup_logger("online_detection_tpu_torch.inference", output_dir)
    logger.info(
        "Start evaluation on %d images (masks=%s, gt_bboxes=%s, batch=%d)",
        len(dataset), with_masks, eval_segm_with_gt_bboxes, b,
    )
    inference_timer = Timer()
    loader_ctx = CanvasLoader(dataset, canvas_hw, min_size, max_size, prefetch=prefetch)
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
            dets_b, mask_b, _, _ = detect(canvases, sizes, dcfg, with_masks, *gt)
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
