"""On-line training on the card: harvest into device reservoirs, then fit
every on-line head from them (counterpart of ``pipelines/device_pipeline.py``).

Per canvas batch only a uint8 canvas and a few KB of GT data cross to the
card; the reservoirs, the minibootstrap splits and the solvers stay there,
and only the trained models come out. The per-batch loop reads nothing back
from the card (the port's NMS, inside the proposal stage, syncs once per
sweep). Both entry points run with TF32 off (``utils.device.ieee_fp32``);
only the conv trunk runs in bf16.

With a ``mesh`` (``parallel/mesh.py``) the harvest runs the trunk (B2, the
RPN, B4, res5) on each device's slice of the canvas batch and gathers its
outputs on the mesh's first device, where the sampling stages and the
reservoirs run as without one (so the harvest's draws and picks do not
depend on the mesh); the training splits every head's classes and the
grouped RLS over the devices.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from online_detection_tpu_torch.data import transforms
from online_detection_tpu_torch.data.datasets import harvest_annotation
from online_detection_tpu_torch.data.loader import CanvasLoader
from online_detection_tpu_torch.data.mask_project import project_masks_for_image
from online_detection_tpu_torch.engine import device_accumulate as dacc
from online_detection_tpu_torch.engine.harvest import (
    HarvestChunk,
    HarvestConfig,
    compact,
    harvest_chunks,
    harvest_trunk,
)
from online_detection_tpu_torch.models.anchors import anchor_visibility, grid_anchors
from online_detection_tpu_torch.models.detector import DetectorConfig, OnlineModelSet
from online_detection_tpu_torch.models.heads import OnlineDetectorModels, OnlineMaskModels
from online_detection_tpu_torch.models.rpn import OnlineRPNModels
from online_detection_tpu_torch.pipelines.online_pipeline import (
    OnlineTrainConfig,
    _fmt,
    _entry_device,
    _StageClock,
    _write_result,
)
from online_detection_tpu_torch.solvers.falkon import FalkonModel
from online_detection_tpu_torch.solvers.minibootstrap import (
    MinibootstrapParams,
    center_uniforms,
    train_classifiers_minibootstrap,
)
from online_detection_tpu_torch.solvers.rls import rls_fit_grouped
from online_detection_tpu_torch.utils.device import ieee_fp32
from online_detection_tpu_torch.utils.device import sync as _sync
from online_detection_tpu_torch.utils.device import to_device as _to_device
from online_detection_tpu_torch.utils.draws import uniform
from online_detection_tpu_torch.utils.stats import zscore
from online_detection_tpu_torch.utils.telemetry import annotate

_LOG = logging.getLogger("online_detection_tpu_torch.device_pipeline")


def _gate_chunk(chunk: HarvestChunk, valid: torch.Tensor) -> HarvestChunk:
    """Clears a padded image's contribution: every validity mask, the AR term
    and the drop counters. ``valid`` broadcasts against the per-image fields
    (a scalar for one image, [B, 1...] for a batch)."""
    def g(m):
        return m & valid

    def z(x):
        return x * valid.to(x.dtype)

    rpn = chunk.rpn
    if rpn is not None:
        rpn = rpn._replace(pos_valid=g(rpn.pos_valid), neg_valid=g(rpn.neg_valid),
                           pos_dropped=z(rpn.pos_dropped))
    det = chunk.det._replace(pos_valid=g(chunk.det.pos_valid), neg_valid=g(chunk.det.neg_valid),
                             coxy_valid=g(chunk.det.coxy_valid),
                             coxy_dropped=z(chunk.det.coxy_dropped))
    mask = chunk.mask
    if mask is not None:
        mask = mask._replace(pos_valid=g(mask.pos_valid), neg_valid=g(mask.neg_valid),
                             labels_valid=g(mask.labels_valid), dropped=z(mask.dropped))
    ar = torch.where(valid, chunk.average_recall, torch.zeros_like(chunk.average_recall))
    return chunk._replace(rpn=rpn, det=det, mask=mask, average_recall=ar)


def _train_head_chunked(neg_pool: dacc.Pool, pos, pos_valid, params: MinibootstrapParams,
                        stats, iterations: int, batch_size: int, mode: str,
                        chunk: Optional[int], generator=None, mesh=None) -> FalkonModel:
    """Minibootstrap a whole head a window of ``chunk`` classes at a time:
    split the window's negatives, train, release. The last window slides back
    to end at the last class; the classes it retrains are dropped from its
    output.

    The head's draws are made once, up front, in absolute class order: the
    shuffle's uniforms [C, cap] ("shuffle" mode), then the Nystrom centers'
    [C, I, 2, M]; each window slices its classes' rows, so neither the
    window width nor the slide changes what a class learns. With ``mesh``
    the window is rounded up to a mesh multiple and each window's classes
    are split over the mesh's devices."""
    c = pos.shape[0]
    dev = pos.device
    chunk = c if not chunk or chunk <= 0 else chunk
    if mesh is not None:
        chunk = -(-chunk // mesh.size) * mesh.size
    chunk = min(chunk, c)
    shuffle_u = uniform((c, neg_pool.capacity), generator, dev) if mode == "shuffle" else None
    center_u = center_uniforms(c, iterations, params.m, generator, dev)
    parts = []
    lo = 0
    while lo < c:
        lo_eff = min(lo, c - chunk)
        drop = lo - lo_eff  # overlap classes already trained
        win = slice(lo_eff, lo_eff + chunk)
        sub = dacc.Pool(neg_pool.rows[win], neg_pool.counts[win])
        if mode == "shuffle":
            neg, neg_valid = dacc.shuffle_split(sub, iterations, batch_size,
                                                uniforms=shuffle_u[win])
        elif mode == "interleave":
            neg, neg_valid = dacc.interleave_split(sub, iterations, batch_size)
        else:  # "arrival": the segmentation pools
            neg, neg_valid = dacc.arrival_split(sub, iterations, batch_size)
        model = train_classifiers_minibootstrap(pos[win], pos_valid[win], neg, neg_valid,
                                                params, stats=stats, mesh=mesh,
                                                uniforms=center_u[win])
        del neg, neg_valid
        parts.append((model.centers[drop:], model.alpha[drop:], model.exists[drop:]))
        lo = lo_eff + chunk
    return FalkonModel(torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
                       torch.cat([p[2] for p in parts]), params.sigma)


def reservoir_spec(cfg: OnlineTrainConfig, hcfg: HarvestConfig, batch_size: int = 1) -> Dict:
    """The ``init_reservoirs`` arguments :func:`harvest_dataset_device` uses
    for this configuration, harvest chunk sizes and canvas batch."""
    return dict(
        num_anchor_classes=cfg.num_anchor_classes, num_classes=cfg.num_classes,
        neg_cap=cfg.batch_size * cfg.iterations, rpn_pos_cap=cfg.rpn_pos_cap,
        det_pos_cap=cfg.det_pos_cap, coxy_cap=cfg.coxy_cap,
        mask_cap=cfg.segm_batch_size * 2, mask_pos_cap=cfg.segm_pos_cap,
        chunk_sizes={"npick": hcfg.negatives_to_pick, "rpn_pos": hcfg.rpn_pos_cap,
                     "gt_cap": hcfg.gt_cap, "coxy": hcfg.coxy_cap,
                     "mask_pix": hcfg.mask_pix_cap},
        with_rpn=cfg.with_rpn, with_mask=cfg.with_segmentation, batch_size=batch_size)


def _sharded_trunk(mesh, params, online_rpn, anchors, dcfg: DetectorConfig,
                   with_mask_features: bool):
    """``harvest_trunk`` over a canvas batch split across ``mesh``: each
    device runs its slice with its replica of the network, and the outputs
    are gathered on the mesh's first device."""

    def shard(images, sizes, gt_boxes, gt_valid, p, r, a):
        return harvest_trunk(p, r, a, images, sizes, gt_boxes, gt_valid, dcfg,
                             with_mask_features)

    def run(images, sizes, gt_boxes, gt_valid):
        return mesh.map(shard, (images, sizes, gt_boxes, gt_valid),
                        (params, online_rpn, anchors))

    return run


def harvest_dataset_device(generator: Optional[torch.Generator], params, dataset,
                           cfg: OnlineTrainConfig, canvas_hw: Tuple[int, int],
                           online_rpn: Optional[OnlineRPNModels] = None,
                           dcfg: DetectorConfig = DetectorConfig(), gt_cap: int = 20,
                           output_dir: Optional[str] = None, min_size: int = 600,
                           max_size: int = 1333, batch_size: int = 1,
                           device=None, mesh=None, prefetch: Optional[str] = None
                           ) -> Tuple[dacc.DeviceReservoirs, Dict]:
    """Streams ``dataset`` through the frozen network into reservoirs on the
    card, ``batch_size`` canvases at a time. Returns (reservoirs, meta).

    ``dataset`` has ``__len__``, ``load_image(i)`` (uint8 RGB), an annotation
    (``harvest_annotation(i)`` or ``get_annotation(i)`` with ``boxes`` and
    1-based ``labels``) and, for the segmentation head, ``load_masks(i,
    anno)``. ``params`` (and ``online_rpn``) must live on ``device``, which
    defaults to the card (the mesh's first device with ``mesh``). Draws come
    from ``generator``. ``mesh``: the canvas batch is rounded up to a mesh
    multiple and the trunk runs on each device's slice. ``prefetch``: the
    ``CanvasLoader`` mode (None, "threads" or "native")."""
    dev = _entry_device(device, mesh)
    if params.rpn.conv_w.device.type != dev.type:
        raise ValueError(f"params are on {params.rpn.conv_w.device}; move them to {dev}")
    with ieee_fp32(), torch.inference_mode(), annotate("harvest"):
        t0 = time.time()
        n_images = len(dataset)
        npick = math.ceil(cfg.batch_size * cfg.iterations / max(n_images, 1))
        hcfg = HarvestConfig(num_anchor_classes=cfg.num_anchor_classes,
                             num_classes=cfg.num_classes, negatives_to_pick=npick,
                             gt_cap=gt_cap)
        ch, cw = canvas_hw
        anchors_np = grid_anchors(ch // 16, cw // 16)
        anchors = torch.from_numpy(anchors_np).to(dev)
        b = max(1, batch_size)
        trunk_fn = None
        if mesh is not None:
            b = -(-b // mesh.size) * mesh.size  # the batch tiles the mesh
            trunk_fn = _sharded_trunk(mesh, params, online_rpn, anchors, dcfg,
                                      cfg.with_segmentation)
        state = dacc.init_reservoirs(**reservoir_spec(cfg, hcfg, b), device=dev)

        def host_item(loader, i):
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
                with annotate("harvest.masks"):
                    gm = project_masks_for_image(dataset.load_masks(i, anno), gb[:g], scale,
                                                 gt_cap)
            return canvas, (sw, sh), gb, gl, gv, gm, anchor_visibility(anchors_np, (sw, sh))

        _LOG.info("harvest (device reservoirs): %d images, batch %d, on %s, mesh %s, "
                  "prefetch %s", n_images, b, dev, None if mesh is None else mesh.size,
                  prefetch)
        with CanvasLoader(dataset, canvas_hw, min_size, max_size, prefetch=prefetch) as loader:
            for lo in range(0, n_images, b):
                with annotate("harvest.load"):
                    items = [host_item(loader, i) for i in range(lo, min(lo + b, n_images))]
                n_real = len(items)
                items += [items[-1]] * (b - n_real)  # pad the tail batch (gated below)

                def stack(k):
                    return _to_device(np.stack([it[k] for it in items]), dev)

                with annotate("harvest.upload"):
                    sizes = _to_device(np.asarray([it[1] for it in items], np.int64), dev)
                    gbs, gls, gvs, viss = stack(2), stack(3), stack(4), stack(6)
                    gms = stack(5) if cfg.with_segmentation else None
                    img_valid = torch.arange(b, device=dev) < n_real
                    images = stack(0)
                with annotate("harvest.trunk"):
                    if trunk_fn is None:
                        trunk = harvest_trunk(params, online_rpn, anchors, images, sizes, gbs,
                                              gvs, dcfg, cfg.with_segmentation)
                    else:
                        trunk = trunk_fn(images, sizes, gbs, gvs)
                del images  # the canvases are not needed past the trunk
                with annotate("harvest.sample"):
                    chunks = harvest_chunks(*trunk, anchors, viss, sizes, gbs, gls, gvs, gms,
                                            hcfg, cfg.with_rpn, generator)
                with annotate("harvest.accumulate"):
                    state = dacc.accumulate_batch(state, chunks, img_valid, cfg.num_classes)
        with annotate("harvest.finish"):
            _sync(dev)
            dt = time.time() - t0
            _LOG.info("harvest done: %d images in %.1f s (%.1f img/s)", n_images, dt,
                      n_images / max(dt, 1e-9))
            _write_result(output_dir,
                          "Detector's features extracted in: {} \n".format(_fmt(dt)))
            meta = {"extraction_time": dt,
                    "average_recall": float(state.ar_sum / state.n_images.clamp(min=1))}
            _write_result(output_dir,
                          "Average Recall (AR): {} \n \n".format(meta["average_recall"]))
            # never truncate silently: per-image chunk caps and saturated pools
            trunc = {"harvest": int(state.harvest_dropped)}
            for name in ("rpn_pos", "rpn_neg", "det_pos", "det_neg", "det_coxy", "mask_pos",
                         "mask_neg"):
                pool = getattr(state, name)
                if pool is not None:
                    trunc[name] = pool.dropped()
            trunc["total"] = sum(trunc.values())
            meta["truncation"] = trunc
            if trunc["total"] > 0:
                _LOG.warning("fixed-capacity truncation during device harvest: %s", trunc)
                _write_result(output_dir, "truncated: {} \n".format(trunc))
    return state, meta


def train_online_modules_device(generator: Optional[torch.Generator], state,
                                cfg: OnlineTrainConfig, output_dir: Optional[str] = None,
                                device=None, timings: Optional[Dict[str, float]] = None,
                                mesh=None) -> OnlineModelSet:
    """Fits the on-line RPN (FALKON + RLS), detector (RLS + FALKON) and
    segmenter (FALKON) from the reservoirs, on ``device`` (the card by
    default; the mesh's first device with ``mesh``), where ``state`` must
    live.

    ``state``: the reservoirs, or a one-element list holding them; the list
    form hands them over, so each pool is freed once its stage has used it.
    ``timings``, when given, receives each stage's seconds (the stage ends in
    a device sync). ``mesh``: every head's minibootstrap and the grouped RLS
    run class-sharded over its devices; the models are gathered on its first
    device."""
    dev = _entry_device(device, mesh)
    if isinstance(state, list):
        state = state.pop()  # take the only reference
    if state.det_neg.rows.device.type != dev.type:
        raise ValueError(f"reservoirs are on {state.det_neg.rows.device}; expected {dev}")
    clock = _StageClock(dev, timings, output_dir)

    def mb(m, sigma, lam):
        return MinibootstrapParams(m=m, sigma=sigma, lam=lam, hard_thresh=cfg.hard_thresh,
                                   easy_thresh=cfg.easy_thresh)

    with ieee_fp32(), torch.inference_mode(), annotate("train"):
        online_rpn = None
        if cfg.with_rpn and state.rpn_neg is not None:
            with annotate("train.prepare"):
                pos = state.rpn_pos.rows
                pos_valid = state.rpn_pos.valid_mask()
                stats_rpn = dacc.device_feature_stats_pool(
                    state.rpn_pos, state.rpn_neg, pos_fraction=cfg.pos_fraction_feat_stats,
                    generator=generator)
            with clock.stage("rpn_falkon", "RPN's Online Classifier training time: {} \n"):
                models = _train_head_chunked(
                    state.rpn_neg, pos, pos_valid, mb(cfg.rpn_m, cfg.rpn_sigma, cfg.rpn_lam),
                    stats_rpn, cfg.iterations, cfg.batch_size,
                    "shuffle" if cfg.rpn_shuffle_negatives else "interleave",
                    cfg.solver_class_chunk, generator, mesh)
                state = state.replace(rpn_neg=None)
            # RPN COXY: the positives' aligned targets; class = anchor index
            with clock.stage("rpn_rls", "RPN's Online Region Refiner training time: {} \n"):
                a_cls = pos.shape[0]
                cls1 = torch.arange(1, a_cls + 1, device=dev)[:, None].expand_as(pos_valid)
                rls = rls_fit_grouped(zscore(pos, stats_rpn).reshape(-1, pos.shape[-1]),
                                      state.rpn_coxy_y.rows.reshape(-1, 4), cls1.reshape(-1),
                                      pos_valid.reshape(-1).float(), a_cls, cfg.rpn_reg_lam,
                                      device_solve=True, mesh=mesh)
            online_rpn = OnlineRPNModels(models, rls, stats_rpn)
            state = state.replace(rpn_pos=None, rpn_coxy_y=None)
            pos = pos_valid = None

        # ---- detector ----
        with annotate("train.prepare"):
            packed = state.det_coxy.rows[0]  # [cap, d + 5]
            d = packed.shape[1] - 5
            coxy_x, coxy_y, coxy_c = packed[:, :d], packed[:, d:d + 4], packed[:, d + 4]
            coxy_valid = state.det_coxy.valid_mask()[0]
            if cfg.use_only_gt_positives_detection:
                det_pos_pool = state.det_pos
                pos, pos_valid = det_pos_pool.rows, det_pos_pool.valid_mask()
            else:
                # positives from the COXY rows, grouped by class on the card
                m = coxy_valid[None, :] & (coxy_c.long()[None, :] == torch.arange(
                    1, cfg.num_classes + 1, device=dev)[:, None])  # [C, N]
                frac = cfg.sampling_ratio_positives_detection
                if frac < 1.0:
                    # a random subset without replacement: the floor(n * frac)
                    # valid rows with the smallest uniform draws
                    r = torch.where(m, uniform(m.shape, generator, dev), torch.full_like(
                        m, 2.0, dtype=torch.float32))
                    rank = torch.sort(torch.sort(r, dim=1, stable=True).indices, dim=1,
                                      stable=True).indices
                    m = m & (rank < torch.floor(m.sum(1, keepdim=True) * frac).long())
                idx, pos_valid = compact(m, state.det_pos.rows.shape[1])
                pos = coxy_x[idx]
                det_pos_pool = dacc.Pool(pos, pos_valid.sum(1))
            stats_det = dacc.device_feature_stats_pool(
                det_pos_pool, state.det_neg, pos_fraction=cfg.pos_fraction_feat_stats,
                generator=generator)
        with clock.stage("det_rls",
                         "Detector's Online Region Refiner training time: {} \n \n"):
            reg_x = zscore(coxy_x, stats_det) if cfg.normalize_features_regressor_detector \
                else coxy_x
            det_rls = rls_fit_grouped(reg_x, coxy_y, coxy_c, coxy_valid.float(),
                                      cfg.num_classes, cfg.det_reg_lam, device_solve=True,
                                      mesh=mesh)
        with clock.stage("det_falkon", "Detector's Online Classifier training time: {} \n"):
            det_falkon = _train_head_chunked(
                state.det_neg, pos, pos_valid, mb(cfg.det_m, cfg.det_sigma, cfg.det_lam),
                stats_det, cfg.iterations, cfg.batch_size,
                "shuffle" if cfg.shuffle_negatives else "interleave", cfg.solver_class_chunk,
                generator, mesh)
            pos = pos_valid = det_pos_pool = packed = coxy_x = coxy_y = coxy_c = reg_x = None
            state = state.replace(det_neg=None, det_pos=None, det_coxy=None)
        online_det = OnlineDetectorModels(det_falkon, det_rls, stats_det)

        # ---- segmentation ----
        online_mask = None
        if cfg.with_segmentation and state.mask_pos is not None:
            seg_iters = max(1, math.ceil(state.mask_neg.rows.shape[1] / cfg.segm_batch_size))
            with annotate("train.prepare"):
                stats_seg = dacc.device_feature_stats_pool(
                    state.mask_pos, state.mask_neg, pos_fraction=cfg.pos_fraction_feat_stats,
                    generator=generator)
            with clock.stage("segm_falkon", "Online Segmentation training time: {} \n"):
                seg_falkon = _train_head_chunked(
                    state.mask_neg, state.mask_pos.rows, state.mask_pos.valid_mask(),
                    mb(cfg.segm_m, cfg.segm_sigma, cfg.segm_lam), stats_seg, seg_iters,
                    cfg.segm_batch_size, "arrival", cfg.solver_class_chunk, generator, mesh)
                state = state.replace(mask_pos=None, mask_neg=None)
            online_mask = OnlineMaskModels(seg_falkon, stats_seg)
    return OnlineModelSet(rpn=online_rpn, detector=online_det, mask=online_mask)
