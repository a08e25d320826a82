#!/usr/bin/env python3
"""Chip smoke for the PyTorch + CUDA port (``online_detection_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed 0]

1. Builds the port's CUDA kernels from ``online_detection_tpu_torch/csrc``
   and the RoIAlign backward kernel that the port's replaced, kept in ``tools/``
   to be timed beside it (one nvcc per source, all started together).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, and times both. B1 (3xTF32 on the tensor
   cores) must stay within 1e-5 of the sum of its terms' magnitudes of the
   IEEE fp32 plain version, its tf32 split must match its plain version bit
   for bit, and its bound is taken at the 3xTF32 rate (495 / 3 TFLOP/s).
   B1 is also held within 1e-5 of the sum of its terms' magnitudes of the
   float64 plain version on seed-built rows at a detector mining pass's
   shape with the norms of the flagship training's own mining rows
   (``mining_rows``; fault C5).
   The RoIAlign kernels B3 and B4 are also held, at full width, on
   adversarial boxes over a 38 x 50 and a 50 x 84 map, and their times are
   printed beside those of the kernels they replaced (``REPLACED_ROI_MS``).
   The stem B2 (bf16 on the tensor cores, fp32 on the CUDA cores) is also
   held at shapes its 8 x 16 tile does not divide and on inputs up to
   |x| = 200, and its bf16 kernel must run bf16 ``HMMA``.
3. Inference: drives ``detect_batched`` at full width (R-50-C4 trunk from a
   numpy seed, 15 anchors, 21 classes, FALKON widths of the flagship
   configuration) on 3 batches of 8 synthetic 608x800 canvases, checks the
   outputs and that every kernel's launch counter rose by the expected
   count, traces one more batch with ``torch.profiler``, and checks the
   card's result against the CPU's plain path on a small input.
4. Training: ``harvest_dataset_device`` over 64 synthetic 800x600 teaching
   images (one coloured ellipse each, 64-192 px a side, the 21 classes in
   turn) at batch 8,
   then ``train_online_modules_device`` with the flagship
   ``OnlineTrainConfig``, then one ``detect_batched`` batch with the trained
   models; checks the launch counts of each path, the models and the
   detections; trains once more from a copy of the same reservoirs and the
   same generator state with every mining pass scored by B1's plain version
   (B1 run beside it, both measured against float64: B1 held within 1e-5
   of the sum of its terms' magnitudes on every pass; exists and RLS held
   equal to the first run's, the FALKON scores and the scores on the other
   side of a mining threshold recorded); holds B4 (the
   harvest RoIAlign) and B1 at the mining shapes against their plain
   versions; traces one harvest batch; and runs harvest
   and training on a few small canvases on the card and on the CPU with the
   same draws.
5. The inference stage: ``run_inference`` with the trained models over 32
   held-out synthetic 800x600 images at batch 8 (4 batches, each kernel's
   launch counter must rise by 4 batches' count), scored by VOC07 det and
   segm mAP@0.5 (finite and in [0, 1]: on random trunk weights their value
   depends on the training draw, so it is printed, not held); prints the
   mAPs, the per-class APs, images/s and ms per image (wall clock, loading
   and scoring included) and the seconds in
   ``voc_eval.evaluate``; traces one more call over one batch; and runs
   ``run_inference`` on 4 small held-out canvases on the card and on the
   CPU, with the detections and with the GT boxes substituted (same
   detections per image and labels, mAPs within 1e-3).
6. The host route: ``harvest_dataset`` over the same 64 teaching images
   one at a time (B = 1: B2 and B4 launch 64 times each), its chunks copied
   to the host and folded by ``HarvestAccumulator``, then
   ``train_online_modules`` (every head in one class chunk: one B1 launch a
   minibootstrap iteration a head) and ``run_inference`` over the 32
   held-out images with those models; prints harvest ms an image, MB copied
   to the host an image, ``finalize`` seconds, the host's peak RSS, seconds
   by stage, peak GiB on the card and the det / segm mAP@0.5 beside the
   device route's; traces the harvest of 4 images.
7. The feature caches: ``save_features`` of a host-route harvest of the
   first 8 teaching images, then ``load_features`` with the shuffle flags
   off (the pools must equal the saved rows) and on (each class's negatives
   must be a permutation of them); the cache is deleted afterwards.
8. The flagship CLI (``online_detection_tpu_torch.experiments.
   run_experiment_online_rpn_ood_oos``) on an on-disk synthetic tree (8
   train and 4 test JPEGs of 240x320, written and read with PIL): the
   device route saving its models, the host route saving the feature
   caches, training from those caches, and the device route again with
   ``--n_devices 1`` (no mesh, as in the JAX CLI: its ``result.txt`` must
   equal the first run's but for the times); each must write the CLI's
   ``result.txt`` lines, give finite mAPs and launch the kernels of its
   path.
9. Checkpoint files and the stock Mask R-CNN path: random full-width
   weights with COCO's 81-class predictors are written as a Caffe2 ``.pkl``
   and a ``.pth`` ("model" key, ``module.`` prefixes) by the port's
   exporters and loaded onto the card (``activation_checksums`` of the
   original and both reloads within rtol 1e-5: the stem kernel's fp32
   route); ``detect_pretrained`` with masks on 8 canvases of 608x800 one at
   a time (B2 +1 and B3 +2 an image), one image traced, the card against the
   CPU on a small canvas; checkpoints A, B, A loaded in turn (A's detections
   must come back); then the feature-task tester CLI over the ``.pkl`` and
   the ``.pth`` on a PIL-written tree, ``weights_smoke --selftest`` and a
   flagship CLI run with ``--weights``. B2's fp32 route and B3 at this
   path's shapes are held against their plain versions and timed.
10. The SGD baselines: ``do_train`` at full width (R-50-C4 from a numpy
   seed, mask head, predictors re-initialised for 22 classes) for 16 steps
   over 8 teaching images of 800x600 (608x800 canvases) with the solver of
   ``config_full_train_ycbv.yaml`` (``roi_batch`` 512, ``post_nms_train``
   300), nothing frozen: finite losses, every leaf moved, the caller's
   params unchanged, B2, B3 and the RoIAlign backward kernel +1 a step; ms
   a step, peak GiB, one step traced. The backward kernel is held against
   its plain version at the step's shapes, on adversarial boxes, on four
   more layouts at the step's map (512 copies of one box; 64 boxes past the
   whole map; 512 adversarial boxes; 512 boxes of the objects' sizes) and
   at the odd shapes of ``BACKWARD_SHAPES``, and timed in turns with the
   kernel it replaced, built from ``REPLACED_BACKWARD_SOURCE``, at the step
   and on each layout; the stem's and RoIAlign's autograd
   gradients are held against autograd of their plain versions, and B2's
   fp32 route is timed at the step's canvas. Then ``dump_backbone_features``
   of the 8 images (B2 +8) and 8 fine-tuning steps from the cached maps
   with the backbone and the RPN's conv frozen (frozen leaves
   bit-identical, no backward launch); one
   ``training_loss`` gradient on a small canvas on the card and on the CPU;
   the two SGD CLIs (``--max_iter 3``; ``--use_backbone_features
   --max_iter 2``) on a PIL-written tree and the tester CLI over the
   fine-tuned ``model_final.pkl``.
11. The module facades, the demo and the teacher, the four remaining CLIs,
   MFU and the f32 trunk: MFU of a ``detect_batched`` batch and of a device
   harvest batch at the bf16 peak (``utils/flops.py``; host clock and traced
   device time); ``OnlineSegmentationDemo.run_on_image`` on 8 held-out
   images (boxes, scores and labels equal to ``detect_batched``'s on the same
   canvas; B1 +3, B2 +1, B3 +2 an image; ``overlay`` on each) and an
   ``IncrementalTeacher`` taught 2 classes, then a third, 4 observations of
   each with masks (every class exists after each ``update_model``; B2 and
   B4 +1 an observation); the device route's training and ``run_inference``
   again with ``ODTPU_COMPUTE_DTYPE=float32`` (launch counts equal to the
   bf16 run's; mAPs and ms a batch beside bf16's; models finite, existing
   where the bf16 run's do; the f32 trunk with the bf16 run's models
   printed beside); the facades on the host
   route's detector pools (``trainRegionClassifier`` held against the
   solver on the same buffers and draws, ``FALKONWrapper.predict`` against
   ``mmv_reference``, ``RegionRefiner`` against the host route's refiners,
   and the standalone experiment scored by ``AccuracyEvaluatorStandalone``
   on the 32 held-out images); and the serial, O-RPN + OOD (``--no_rpn``),
   segmentation (GT boxes: det mAP > 0.99) and visualizer CLIs on the
   flagship CLI's tree.
12. The device mesh (``parallel/mesh.py``) as two entries on the one card,
   ``Mesh(devices=[cuda:0, cuda:0])``, after the inference stage: the
   teaching set harvested unsharded and with each canvas batch split 4 + 4
   (reservoirs bit-identical), both harvests trained, unsharded and with
   every head's classes and the grouped RLS split in two (exists identical,
   scores within 1e-4, RLS mu within 1e-5, beta within 2e-3, t_inv within
   1e-4), and ``run_inference`` on the mesh with the mesh-trained models
   (det and segm mAP@0.5 within ``MESH_MAP_TOL`` of the inference stage's);
   every kernel launches once per device slice.
13. The canvas prefetcher: the 64 teaching images written as 800x600 JPEGs
   (quality 95, PIL) and harvested at batch 8 with ``prefetch=None`` and
   ``"threads"`` (None, threads, threads, None): reservoirs bit-identical,
   ms per image of each.
14. Prints one ``{"kernels": [...]}`` line (launches counted over every
   path), the card's name and power limit, and, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failed phase raises and exits non-zero, with no result line. Details
(compiler logs, per-call timings) go to ``chiprun_out/chip_smoke.json``, the
traced batches' device time by kernel and idle share to
``chiprun_out/detect_profile.txt``, ``chiprun_out/harvest_profile.txt`` and
``chiprun_out/inference_profile.txt``, and ``run_inference``'s ``result.txt``
and log to ``chiprun_out/inference/``.
Beside them, the host route's traced harvest goes to
``host_harvest_profile.txt``, each CLI run's ``result.txt`` to ``cli/`` and
the traced ``detect_pretrained`` image to ``pretrained_profile.txt``, the
traced training step to ``sgd_profile.txt``, and the visualizer's PNGs to
``cli/viz/``.
Scratch files (the feature caches, the CLI's tree and outputs, the
checkpoint files) live under ``.bench/`` and are deleted.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# CUDA sources, one library each
KERNELS = ("gaussian_mmv", "stem_pool", "roi_align", "roi_align_fused2", "roi_align_backward")
# launch counters: B1 is two kernels of gaussian_mmv.cu, the centers' tf32
# split ("tf32_split") and the mmv itself, each launched once per call
COUNTERS = ("gaussian_mmv", "tf32_split", "stem_pool", "roi_align", "roi_align_fused2",
            "roi_align_backward")
# the kernels of the on-line system's paths (the RoIAlign backward runs only
# in the SGD baselines)
ONLINE_COUNTERS = COUNTERS[:-1]
# per batch of detect_batched
EXPECTED_LAUNCHES = {"gaussian_mmv": 3, "tf32_split": 3, "stem_pool": 1, "roi_align": 2,
                     "roi_align_fused2": 0, "roi_align_backward": 0}
# NVIDIA H100 SXM data sheet, dense: fp32 on CUDA cores, TF32 and bf16 on
# tensor cores (fp32 accumulate), HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# B1 runs 3xTF32: three tensor-core passes per product
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
# B1 per call on the same kind of card with the SIMT fp32 kernel this one
# replaced (PERF.md, section 6)
SIMT_B1_MS = {"rpn": 11.52, "detector": 6.64, "mask": 1.63, "mining rpn": 8.78,
             "mining detector": 17.25, "mining mask": 3.72}
# B3 (proposals, detections) and B4 (harvest) per call on the same kind of
# card with the kernels these replaced (B3 sampled each bin directly, B4
# contracted H first per pooled row; tools/roi_variants.py keeps both and
# times them beside the new ones)
REPLACED_ROI_MS = {"proposals": 2.030, "detections": 0.767, "harvest": 1.631}
# the RoIAlign backward per training step (g [1, 512, 14, 14, 1024] f32 onto
# 38 x 50) on the same kind of card with the kernel this one replaced (it
# re-read g from device memory for each column its bins reach), as recorded
# before; its source is kept, and this smoke builds it and times it again
# beside the new one on every layout
REPLACED_BACKWARD_MS = 0.598
REPLACED_BACKWARD_SOURCE = ROOT / "tools" / "roi_align_backward_replaced.cu"
# B2 per inference batch (bf16, [8, 608, 800, 3]) on the same kind of card
# with the SIMT fp32 kernel the bf16 route replaced (PERF.md, section 6); the
# fp32 route still runs it
SIMT_B2_MS = 0.726

# flagship on-line widths (OnlineTrainConfig of the JAX package's online pipeline)
N_CLASSES, N_ANCHORS = 21, 15
RPN_M, RPN_SIGMA, DET_M, DET_SIGMA, MASK_M, MASK_SIGMA = 1000, 50.0, 1000, 15.0, 500, 10.0
CANVAS = (608, 800)
BATCHES, BATCH_SIZE = 3, 8
# teaching images of 800x600 need no resize: min side 600, canvas 608x800
TRAIN_IMAGES, TRAIN_HW = 64, (600, 800)
# held-out images scored by run_inference (4 batches of 8), from seed + 1
HELD_OUT_IMAGES = 32
# sides of the teaching and held-out objects, in pixels. With the trunk's
# random weights, what the on-line RPN learns to propose depends on the
# objects' sizes: with sides up to 3/4 of the image its proposals miss the
# held-out objects and det mAP@0.5 is 0 (tools/map_by_object_size.py and
# PERF.md hold the sweep that picked this range)
OBJECT_SIDES = (64, 192)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def timed(fn, iters: int = 5):
    """Mean ms of ``fn`` over ``iters`` launches (CUDA events, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(x):
    import torch

    mag = x.abs().clamp(min=1e-30)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_close(name, got, ref, tol, report):
    """|got - ref| <= tol elementwise; records the largest error."""
    err = (got.float() - ref.float()).abs()
    worst = float((err - tol).max())
    report.setdefault(name, {})["max_abs_err"] = max(
        report.get(name, {}).get("max_abs_err", 0.0), float(err.max()))
    if not torch_isfinite(got) or worst > 0:
        fail(f"{name}: kernel disagrees with its plain version (max err {float(err.max())}, "
             f"over tolerance by {worst})")


def bound_of(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS):
    """(least ms the card could take, "operations" or "bytes": which bounds it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def add_call(rec, call, peak_flops=PEAK_FP32_FLOPS):
    """Adds one call's times to its kernel's totals; the kernel's bound is the
    sum of its calls' bounds, bounded by what bounds their sum."""
    rec["calls"].append(call)
    for k in ("ms", "plain_ms", "bound_ms", "flops", "bytes"):
        rec[k] = rec.get(k, 0.0) + call[k]
    rec["bound_by"] = bound_of(rec["flops"], rec["bytes"], peak_flops)[1]


def torch_isfinite(t) -> bool:
    import torch

    return bool(torch.isfinite(t.float()).all())


def tensor_core_sass(lib: str, kernel: str, opcode: str, dtype: str) -> dict:
    """A kernel's tensor-core instructions in its built library (``cuobjdump
    -sass``): fails unless ``kernel`` runs ``opcode`` on ``dtype`` operands
    and nothing else on the tensor cores."""
    from online_detection_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build._lib_path(lib))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    name, lines = "", {}
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif opcode in line:
            lines.setdefault(name, []).append(line.split(";")[0].split("*/")[-1].strip())
    found = [ln for k, ls in lines.items() if kernel in k for ln in ls]
    if not found or not all(dtype in ln for ln in found):
        fail(f"{kernel} runs no {dtype} {opcode}: {lines}")
    return {"count": len(found), "first": found[0]}


# ---------------------------------------------------------------------------
# set-up: random network, on-line models drawn from the port's own features


def feature_stats(rows):
    from online_detection_tpu_torch.utils.stats import FeatureStats

    return FeatureStats(rows.mean(0), rows.std(0), rows.norm(dim=1).mean())


def random_falkon(rng, z_rows, classes, m, sigma, dev):
    import numpy as np
    import torch

    from online_detection_tpu_torch.solvers.falkon import FalkonModel

    idx = torch.from_numpy(rng.integers(0, z_rows.shape[0], size=(classes, m))).to(dev)
    alpha = rng.normal(size=(classes, m)).astype(np.float32)
    alpha -= alpha.mean(1, keepdims=True)
    return FalkonModel(z_rows[idx].contiguous(), torch.from_numpy(alpha * 0.1).to(dev),
                       torch.ones(classes, dtype=torch.bool, device=dev), sigma)


def random_rls(rng, classes, d, dev):
    import numpy as np
    import torch

    from online_detection_tpu_torch.solvers.rls import RLSModel

    eye = torch.eye(4, device=dev).expand(classes, 4, 4).contiguous()
    beta = torch.from_numpy(rng.normal(size=(classes, d + 1, 4)).astype(np.float32) * 1e-4)
    return RLSModel(beta.to(dev), eye, eye, torch.zeros(classes, 4, device=dev),
                    torch.ones(classes, dtype=torch.bool, device=dev),
                    torch.zeros(classes, 4, device=dev))


def build_online(rng, params, images, sizes, anchors, cfg, dev):
    """On-line models whose centers are z-scored features of a first batch,
    so kernel values are not all ~0. Returns the models and the kernels'
    inputs at main-path shapes."""
    import torch

    from online_detection_tpu_torch.data.transforms import normalize_canvas
    from online_detection_tpu_torch.models import resnet
    from online_detection_tpu_torch.models.detector import OnlineModelSet
    from online_detection_tpu_torch.models.heads import (
        OnlineDetectorModels, OnlineMaskModels, mask_deconv)
    from online_detection_tpu_torch.models.rpn import (
        OnlineRPNModels, propose, rpn_features, rpn_online_flat)
    from online_detection_tpu_torch.ops.roi_align import roi_align_batched
    from online_detection_tpu_torch.utils.stats import zscore

    b = images.shape[0]
    x = normalize_canvas(images).to(torch.bfloat16)
    c4 = resnet.backbone_c4(params.backbone, x)
    t = rpn_features(params.rpn, c4)
    rows = t.reshape(-1, t.shape[-1])
    rpn_stats = feature_stats(rows.float())
    z_rpn = zscore(rows, rpn_stats)
    rpn = OnlineRPNModels(random_falkon(rng, z_rpn, N_ANCHORS, RPN_M, RPN_SIGMA, dev),
                          random_rls(rng, N_ANCHORS, rows.shape[1], dev), rpn_stats)
    s, d = rpn_online_flat(rpn, rows)
    props, _, _ = propose(s.reshape(b, -1), d.reshape(b, -1, 4), anchors, sizes,
                          cfg.pre_nms_top_n, cfg.post_nms_top_n, cfg.rpn_nms_thresh)
    pooled = roi_align_batched(c4, props)
    feats = resnet.res5_head(params.backbone, pooled.reshape((-1,) + pooled.shape[2:]))
    det_stats = feature_stats(feats.float())
    z_det = zscore(feats, det_stats)
    det = OnlineDetectorModels(random_falkon(rng, z_det, N_CLASSES, DET_M, DET_SIGMA, dev),
                               random_rls(rng, N_CLASSES, feats.shape[1], dev), det_stats)
    n_det = cfg.detections_per_img
    dets_like = props[:, :n_det].contiguous()
    pooled2 = roi_align_batched(c4, dets_like)
    res5 = resnet.res5_feature_map(params.backbone, pooled2.reshape((-1,) + pooled2.shape[2:]))
    deconv = mask_deconv(params.mask_head, res5)  # [B*D, 14, 14, 256]
    pix = deconv.reshape(-1, deconv.shape[-1])
    mask_stats = feature_stats(pix)
    z_pix = zscore(pix, mask_stats)
    mask = OnlineMaskModels(random_falkon(rng, z_pix, N_CLASSES, MASK_M, MASK_SIGMA, dev),
                            mask_stats)
    labels = torch.from_numpy(rng.integers(1, N_CLASSES + 1, size=deconv.shape[0])).to(dev)
    inputs = {
        "x": x, "c4": c4, "props": props, "dets": dets_like,
        "mmv": [("rpn", z_rpn, rpn.falkon, None),
                ("detector", z_det, det.falkon, None),
                ("mask", z_pix.reshape(deconv.shape[0], -1, pix.shape[1]), mask.falkon,
                 (labels - 1).to(torch.int32))],
    }
    return OnlineModelSet(rpn, det, mask), inputs


# ---------------------------------------------------------------------------
# kernel vs plain version, at main-path shapes


def check_split(role, centers, report):
    """The split kernel against its plain version on the centers of one B1
    call: hi and lo bit for bit, the squared norms to 1e-5 relative (fp32
    sums in another order). Bound: read 4 and write 8 bytes per value."""
    import torch

    from online_detection_tpu_torch.ops.gaussian_mmv import split_tf32, split_tf32_reference

    hi, lo, sq = split_tf32(centers)
    rhi, rlo, rsq = split_tf32_reference(centers)
    if not (torch.equal(hi.view(torch.int32), rhi.view(torch.int32))
            and torch.equal(lo.view(torch.int32), rlo.view(torch.int32))):
        fail(f"tf32_split[{role}]: kernel and plain version differ in bits")
    check_close("tf32_split", sq, rsq, 1e-5 * rsq.abs(), report)
    rec = report["tf32_split"]
    rec.setdefault("calls", [])
    rec["tolerance"] = "hi, lo bit-exact; squared norms 1e-5 relative"
    ms = timed(lambda: split_tf32(centers), 10)
    plain = timed(lambda: split_tf32_reference(centers), 3)
    rows = centers.numel() // centers.shape[-1]
    flops, nbytes = 5.0 * centers.numel(), 12.0 * centers.numel() + 4.0 * rows
    add_call(rec, {"role": role, "shape": list(centers.shape), "ms": ms, "plain_ms": plain,
                   "bound_ms": bound_of(flops, nbytes)[0], "flops": flops, "bytes": nbytes})
    return ms


def check_mmv_call(role, x, fm, set_idx, report, iters=5, plain_iters=3):
    """B1 at one main-path call against its plain version (IEEE fp32), timed;
    its bound at the 3xTF32 rate, with the fp32 CUDA-core bound beside it."""
    from online_detection_tpu_torch.ops.gaussian_mmv import mmv_grouped, mmv_reference

    rec = report.setdefault("gaussian_mmv", {"calls": []})
    v = fm.alpha
    got = mmv_grouped(x, fm.centers, v, fm.sigma, set_idx)
    ref = mmv_reference(x, fm.centers, v, fm.sigma, set_idx)
    # 1e-5 of the sum of the terms' magnitudes (K >= 0, so that is K @ |v|)
    terms = mmv_reference(x, fm.centers, v.abs(), fm.sigma, set_idx)
    check_close("gaussian_mmv", got, ref, 1e-5 * terms + 1e-30, report)
    rel = float(((got - ref).abs() / terms.clamp(min=1e-30)).max())
    del got, ref, terms
    ms = timed(lambda: mmv_grouped(x, fm.centers, v, fm.sigma, set_idx), iters)
    plain = timed(lambda: mmv_reference(x, fm.centers, v, fm.sigma, set_idx), plain_iters)
    split_ms = check_split(role, fm.centers, report)
    g = fm.centers.shape[0] if set_idx is None else set_idx.shape[0]
    n, d = x.shape[-2], x.shape[-1]
    m = fm.centers.shape[1]
    flops = 2.0 * g * n * m * (d + 1)
    nbytes = 4.0 * (x.numel() + fm.centers.numel() + v.numel() + g * n)
    bound, by = bound_of(flops, nbytes, PEAK_3XTF32_FLOPS)
    add_call(rec, {"role": role, "groups": g, "rows": n, "centers": m, "d": d,
                   "ms": ms, "plain_ms": plain, "bound_ms": bound, "flops": flops,
                   "bytes": nbytes, "bound_fp32_ms": bound_of(flops, nbytes)[0],
                   "split_ms": split_ms, "simt_fp32_ms": SIMT_B1_MS[role], "max_rel_to_terms": rel},
             PEAK_3XTF32_FLOPS)
    rec["bound_fp32_ms"] = rec.get("bound_fp32_ms", 0.0) + rec["calls"][-1]["bound_fp32_ms"]
    print(f"  gaussian_mmv[{role}] G={g} N={n} M={m} d={d}: {ms:.3f} ms (SIMT fp32 kernel "
          f"{SIMT_B1_MS[role]:.2f} ms; plain {plain:.3f} ms; 3xTF32 bound {bound:.3f} ms, {by}; "
          f"of it the split {split_ms:.3f} ms; max err {rel:.2e} of sum |terms|)", flush=True)


# a detector mining pass (groups, rows, centers, d, sigma) for the seed-built
# check of B1 on rows like the flagship training's own mining rows
MINING_ROWS = (8, 20000, 1000, 2048, 15.0)
# the norms of the detector's mining rows and of their centers (median, 99th
# percentile, maximum) over the mining passes of seven training draws, as
# tools/b1_variants.py measured them (PERF.md, section 6)
MINING_ROW_NORMS = {"rows": (2.875, 16.80, 18.00), "centers": (8.053, 16.57, 18.00)}
# the cosine of the seed-built rows and centers to a common direction: the
# same passes' centers lie at a median cosine of 0.99997 to their class's
# mean center, and 1 % of the rows above 0.977
MINING_COSINE = 0.95


def mining_rows(seed, cosine=MINING_COSINE):
    """Rows and centers at ``MINING_ROWS``'s shape whose norms are log-normal
    with the medians and 99th percentiles of ``MINING_ROW_NORMS`` (cut at
    its maxima, which one row and one center a group take), each at ``cosine``
    to its group's common direction, as a class's rows are: every cross
    term x.c is large, and a bias of the tensor cores' sums shows in every
    term at once. v >= 0, so no term's error cancels another's."""
    import math

    import torch

    g, n, m, d, sigma = MINING_ROWS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    e = torch.randn((g, 1, d), generator=gen, device="cuda")
    e /= e.norm(dim=-1, keepdim=True)

    def draw(count, median, p99, top):
        spread = math.log(p99 / median) / 2.3263  # the normal's 99th percentile
        r = torch.exp(math.log(median)
                      + spread * torch.randn((g, count), generator=gen, device="cuda"))
        r = r.clamp(max=top)
        r[:, 0] = top
        u = torch.randn((g, count, d), generator=gen, device="cuda")
        u -= (u * e).sum(-1, keepdim=True) * e
        u /= u.norm(dim=-1, keepdim=True)
        return (cosine * e + math.sqrt(1.0 - cosine * cosine) * u) * r[..., None]

    c = draw(m, *MINING_ROW_NORMS["centers"])
    x = draw(n, *MINING_ROW_NORMS["rows"])
    v = torch.randn((g, m), generator=gen, device="cuda").abs()
    return x, c, v, sigma


def mining_rows_error(fn, seed, cosine=MINING_COSINE) -> float:
    """``fn(x, centers, v, sigma)`` on ``mining_rows``: its largest distance
    from the float64 plain version, as a share of the sum of the terms'
    magnitudes."""
    from online_detection_tpu_torch.ops.gaussian_mmv import mmv_reference

    x, c, v, sigma = mining_rows(seed, cosine)
    got = fn(x, c, v, sigma).double()
    x, c, v = x.double(), c.double(), v.double()
    ref = mmv_reference(x, c, v, sigma)
    terms = mmv_reference(x, c, v.abs(), sigma).clamp(min=1e-30)
    return float(((got - ref).abs() / terms).max())


def check_mmv_mining_rows(seed, report):
    """B1 on ``mining_rows``: within 1e-5 of the sum of its terms'
    magnitudes of the float64 plain version, else the smoke fails. The fp32
    plain version's error on the same rows is recorded beside it."""
    from online_detection_tpu_torch.ops.gaussian_mmv import mmv_grouped, mmv_reference
    from online_detection_tpu_torch.utils.device import ieee_fp32

    err = mining_rows_error(mmv_grouped, seed)
    with ieee_fp32():
        plain = mining_rows_error(mmv_reference, seed)
    report["gaussian_mmv"]["mining_rows"] = {
        "shape": MINING_ROWS, "norms": MINING_ROW_NORMS, "cosine": MINING_COSINE,
        "max_rel_to_terms": err, "fp32_plain_max_rel_to_terms": plain}
    print(f"  gaussian_mmv on seed-built mining rows {MINING_ROWS} with the training's norms "
          f"{MINING_ROW_NORMS} at cosine {MINING_COSINE} to a common direction: {err:.2e} of "
          f"sum |terms| from float64 (fp32 plain version {plain:.2e})", flush=True)
    if not err <= 1e-5:
        fail(f"gaussian_mmv on the seed-built mining rows: {err:.3g} of sum |terms| from "
             f"float64, over 1e-5")


def check_mmv(inputs, report):
    for role, x, fm, set_idx in inputs["mmv"]:
        check_mmv_call(role, x, fm, set_idx, report)
    report["gaussian_mmv"]["tolerance"] = "1e-5 of sum |terms| (fp32 plain version)"


def check_stem(params, inputs, report):
    from online_detection_tpu_torch.ops.stem_pool import stem_fused, stem_reference

    p = params.backbone.stem
    x = inputs["x"]  # [B, H, W, 3] bf16
    args = (p.weight, p.scale, p.bias)
    got, ref = stem_fused(x, *args), stem_reference(x, *args)
    # both round one fp32 result to bf16: 1 ulp, plus fp32 summation noise
    check_close("stem_pool", got, ref, bf16_ulp(ref.float()) + 1e-5 * ref.float().abs().max(),
                report)
    xf = x.float()
    ref32 = stem_reference(xf, *args)
    check_close("stem_pool", stem_fused(xf, *args), ref32, 1e-5 * ref32.abs().max(), report)
    ms = timed(lambda: stem_fused(x, *args), 20)
    plain = timed(lambda: stem_reference(x, *args), 3)
    f32_ms = timed(lambda: stem_fused(xf, *args), 10)
    b, h, w, _ = x.shape
    h2, w2 = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    flops = 2.0 * b * h2 * w2 * 64 * 147
    nbytes = 2.0 * (x.numel() + got.numel()) + 4.0 * (p.weight.numel() + 128)
    # a bf16 conv with fp32 accumulation is an implicit GEMM (K = 7*7*3 = 147)
    # that the tensor cores run: its bound is at their bf16 rate
    bound, by = bound_of(flops, nbytes, PEAK_BF16_FLOPS)
    report["stem_pool"].update(
        ms=ms, plain_ms=plain, bound_ms=bound, flops=flops, bytes=nbytes, bound_by=by,
        f32_route_ms=f32_ms, simt_bf16_ms=SIMT_B2_MS,
        tolerance="bf16: 1 ulp + 1e-5 max|ref|; f32: 1e-5 max|ref|", shape=list(x.shape))
    print(f"  stem_pool {list(x.shape)} bf16: {ms:.4f} ms (SIMT kernel {SIMT_B2_MS:.3f} ms; "
          f"plain {plain:.3f} ms; bound {bound:.4f} ms, {by}: {bound / ms:.1%} of it); "
          f"f32 route (SIMT) {f32_ms:.3f} ms", flush=True)


def check_stem_shapes(seed, report):
    """B2 against its plain version, bf16 and f32, at shapes whose pooled
    grid the bf16 kernel's 8 x 16 tile does not divide or whose conv rows or
    columns are odd, and on an input of large magnitude (|x| up to 200, for
    the fp32 accumulation). Random weights, scale and bias from the seed."""
    import numpy as np
    import torch

    from online_detection_tpu_torch.ops.stem_pool import stem_fused, stem_reference

    rng = np.random.default_rng(seed + 2)

    def cuda(a):
        return torch.from_numpy(a.astype(np.float32)).cuda()

    args = (cuda(rng.normal(size=(64, 3, 7, 7)) * 0.05), cuda(rng.uniform(0.5, 1.5, 64)),
            cuda(rng.normal(size=64) * 0.1))
    cases = [((1, 8, 8, 3), 3.0), ((2, 37, 53, 3), 3.0), ((3, 600, 804, 3), 3.0),
             ((2, 64, 96, 3), 200.0)]
    worst = {}
    for shape, mag in cases:
        x = cuda(rng.uniform(-mag, mag, size=shape))
        for dt in (torch.bfloat16, torch.float32):
            xd = x.to(dt)
            got, ref = stem_fused(xd, *args), stem_reference(xd, *args)
            ref32 = ref.float()
            tol = 1e-5 * ref32.abs().max()
            if dt == torch.bfloat16:
                tol = bf16_ulp(ref32) + tol
            check_close("stem_pool", got, ref, tol, report)
            key = f"{'x'.join(map(str, shape[:3]))} |x|<={mag:g} {str(dt).split('.')[-1]}"
            worst[key] = float((got.float() - ref32).abs().max())
    report["stem_pool"]["adversarial_max_abs_err"] = worst
    print(f"  stem_pool at ragged and odd shapes and |x| <= 200: max err {worst}", flush=True)


def roi_ops(rois, h, w, c, pooled=14, scale=1.0 / 16.0):
    """Operations this call's boxes need: 4 taps x 2 per sample and channel."""
    import torch

    r = rois.reshape(-1, 4).float()
    size_w = torch.clamp((r[:, 2] - r[:, 0]) * scale, min=1.0)
    size_h = torch.clamp((r[:, 3] - r[:, 1]) * scale, min=1.0)
    n_w = torch.clamp(torch.ceil(size_w / pooled), 1, 8)
    n_h = torch.clamp(torch.ceil(size_h / pooled), 1, 8)
    return float((n_w * n_h).sum()) * pooled * pooled * c * 8.0


def roi_footprint(rois, h, w, pooled=14, scale=1.0 / 16.0, max_samples=8):
    """[..., 4] boxes -> [...] int: the feature cells of an [h, w] map that
    each RoI's gradient reaches in the RoIAlign backward kernel, the rows
    times the columns that lie between some bin's first and last tap. At
    ``pooled`` <= 16 the kernel adds into each such cell once per channel
    vector, with one atomic. Sample coordinates are rounded op by op in
    float32, as the kernels round them."""
    import torch

    r = rois.reshape(-1, 4).float()

    def covered(lo, hi, dim):
        start = lo * scale
        bin_size = (torch.clamp(hi * scale - start, min=1.0) / pooled)[:, None]
        n = torch.clamp(torch.ceil(bin_size), 1, max_samples)
        p = torch.arange(pooled, dtype=torch.float32, device=r.device)[None]

        def tap(s):  # the lower tap row of sample s of every bin
            coord = start[:, None] + (p + (s + 0.5) / n) * bin_size
            return torch.floor(coord.clamp(0.0, dim - 1.0))

        first, last = tap(0.0), torch.clamp(tap(n - 1.0) + 1.0, max=dim - 1.0)
        grid = torch.arange(dim, dtype=torch.float32, device=r.device)
        inside = (grid >= first[..., None]) & (grid <= last[..., None])  # [R, P, dim]
        return inside.any(dim=1).sum(-1)

    return (covered(r[:, 1], r[:, 3], h) * covered(r[:, 0], r[:, 2], w)).reshape(
        rois.shape[:-1])


def check_roi(inputs, report):
    from online_detection_tpu_torch.ops.roi_align import roi_align_batched, roi_align_reference

    c4 = inputs["c4"]
    rec = report.setdefault("roi_align", {"calls": []})
    for role, rois in (("proposals", inputs["props"]), ("detections", inputs["dets"])):
        got, ref = roi_align_batched(c4, rois), roi_align_reference(c4, rois)
        check_close("roi_align", got, ref,
                    bf16_ulp(ref.float()) + 1e-5 * ref.float().abs().max(), report)
        c4f = c4.float()
        ref32 = roi_align_reference(c4f, rois)
        check_close("roi_align", roi_align_batched(c4f, rois), ref32,
                    1e-5 * ref32.abs().max(), report)
        ms = timed(lambda: roi_align_batched(c4, rois), 10)
        plain = timed(lambda: roi_align_reference(c4, rois), 3)
        b, h, w, c = c4.shape
        flops = roi_ops(rois, h, w, c)
        nbytes = 2.0 * (c4.numel() + got.numel()) + 4.0 * rois.numel()
        bound, by = bound_of(flops, nbytes)
        add_call(rec, {"role": role, "shape": list(got.shape), "ms": ms, "plain_ms": plain,
                       "bound_ms": bound, "flops": flops, "bytes": nbytes,
                       "replaced_ms": REPLACED_ROI_MS[role]})
        print(f"  roi_align[{role}] {list(got.shape)} bf16: {ms:.3f} ms (replaced kernel "
              f"{REPLACED_ROI_MS[role]:.3f} ms; plain {plain:.3f} ms; bound {bound:.3f} ms, {by}: "
              f"{bound / ms:.0%} of it)", flush=True)
    rec["tolerance"] = "bf16: 1 ulp + 1e-5 max|ref|; f32: 1e-5 max|ref|"


def adversarial_rois(rng, b, r, hi):
    """Random boxes, and in each image a zero-area box, boxes past the far
    and the near edge, and a box wider than 8 x 14 feature cells (the
    8-sample clamp): the boxes ``tests/test_torch_roi_align.py`` makes."""
    import numpy as np

    raw = rng.uniform(0, hi, size=(b, r, 4)).astype(np.float32)
    rois = np.concatenate([np.minimum(raw[..., :2], raw[..., 2:]),
                           np.maximum(raw[..., :2], raw[..., 2:])], -1)
    rois[:, 0] = [50.0, 40.0, 50.0, 40.0]
    rois[:, 1] = [hi - 20, hi - 30, hi + 200, hi + 150]
    rois[:, 2] = [-60.0, -40.0, 30.0, 20.0]
    rois[:, 3] = [0.0, 0.0, 2000.0, 1900.0]
    return rois


def check_roi_adversarial(seed, report):
    """B3 and B4 against their plain versions at full width (C = 1024), bf16
    and f32, on adversarial boxes over a 608x800 map (38 x 50) and a
    1333-pixel-wide one (50 x 84), random-normal features. The plain
    versions run on the CPU here, on the same inputs: on the card their
    einsums drift from a float64 evaluation by up to 4.5e-5 at W = 84 on
    these features, over the 1e-5 tolerance, while the kernels stay within
    4e-7 of it (NVIDIA H100 80GB HBM3)."""
    import numpy as np
    import torch

    from online_detection_tpu_torch.ops.roi_align import (
        roi_align_batched, roi_align_fused2, roi_align_fused2_reference, roi_align_reference)

    rng = np.random.default_rng(seed + 1)
    worst = {}
    for h, w in ((38, 50), (50, 84)):
        feats = torch.from_numpy(rng.normal(size=(2, h, w, 1024)).astype(np.float32)).cuda()
        rois = torch.from_numpy(adversarial_rois(rng, 2, 24, 16.0 * w)).cuda()
        for name, fn, plain in (("roi_align", roi_align_batched, roi_align_reference),
                                ("roi_align_fused2", roi_align_fused2,
                                 roi_align_fused2_reference)):
            for dt in (torch.bfloat16, torch.float32):
                f = feats.to(dt)
                got, ref = fn(f, rois).cpu(), plain(f.cpu(), rois.cpu())
                ref32 = ref.float()
                tol = 1e-5 * ref32.abs().max()
                if dt == torch.bfloat16:
                    tol = bf16_ulp(ref32) + tol
                check_close(name, got, ref, tol, report)
                key = f"{name} {h}x{w} {str(dt).split('.')[-1]}"
                worst[key] = float((got.float() - ref32).abs().max())
    for name in ("roi_align", "roi_align_fused2"):
        report[name]["adversarial_max_abs_err"] = {k: v for k, v in worst.items()
                                                   if k.split()[0] == name}
    print(f"  roi_align, roi_align_fused2 on adversarial boxes (zero-area, past both edges, "
          f"8-sample clamp), C=1024, 38x50 and 50x84 maps: max err {worst}", flush=True)


# ---------------------------------------------------------------------------
# the main path


def check_detections(dets, masks, props, pvalid, b, cfg):
    import torch

    d, p = cfg.detections_per_img, cfg.pooler_resolution
    shapes = {"boxes": (tuple(dets.boxes.shape), (b, d, 4)),
              "scores": (tuple(dets.scores.shape), (b, d)),
              "labels": (tuple(dets.labels.shape), (b, d)),
              "masks": (tuple(masks.shape), (b, d, p, p)),
              "proposals": (tuple(props.shape), (b, cfg.post_nms_top_n, 4))}
    for k, (got, want) in shapes.items():
        if got != want:
            fail(f"{k} shape {got}, expected {want}")
    for k, t in (("boxes", dets.boxes), ("scores", dets.scores), ("masks", masks),
                 ("proposals", props)):
        if not torch_isfinite(t):
            fail(f"non-finite {k}")
    v = dets.valid
    if not bool(v.any()) or not bool(pvalid.any()):
        fail("no valid detections or proposals")
    if bool((dets.boxes[~v] != 0).any()) or bool((dets.labels[~v] != 0).any()):
        fail("padding rows are not zeroed")
    lab = dets.labels[v]
    if bool(((lab < 1) | (lab > N_CLASSES)).any()):
        fail("labels out of range")
    if bool(((masks < 0) | (masks > 1)).any()):
        fail("mask probabilities out of [0, 1]")
    return int(v.sum())


def small_reference_check(params, online, dev, report):
    """The card (kernels, fp32 trunk) against the CPU (plain versions) on a
    small canvas, full-width network and models. Near-equal scores may swap
    places between the two, so detections are compared as sorted scores."""
    import numpy as np
    import torch

    from online_detection_tpu_torch.models.anchors import grid_anchors
    from online_detection_tpu_torch.models.detector import DetectorConfig, detect_batched

    rng = np.random.default_rng(123)
    h, w, b = 128, 192, 2
    images = rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8)
    sizes = np.array([[w, h], [w - 24, h - 16]], np.float32)
    anchors = grid_anchors(h // 16, w // 16)
    cfg = DetectorConfig(pre_nms_top_n=200, post_nms_top_n=50, detections_per_img=20,
                         compute_dtype="float32")

    def run(device, p, o):
        dets, masks, _, pvalid = detect_batched(p, o, anchors, images, sizes, cfg,
                                                device=device)
        return dets.scores.cpu(), dets.valid.cpu(), masks.cpu(), pvalid.cpu()

    sg, vg, mg, pg = run(dev, params, online)
    sc, vc, mc, pc = run("cpu", copy.deepcopy(params).to("cpu"), online.to("cpu"))
    err = {
        "n_valid": [int(vg.sum()), int(vc.sum())],
        "n_proposals": [int(pg.sum()), int(pc.sum())],
        "sorted_scores_max_err": float((sg.sort(-1).values - sc.sort(-1).values).abs().max()),
        "mask_mean_err": float((mg.mean() - mc.mean()).abs()),
    }
    report["small_reference"] = err
    print(f"  card vs CPU plain path on {b}x{h}x{w}: {err}", flush=True)
    if err["n_valid"][0] != err["n_valid"][1] or err["n_proposals"][0] != err["n_proposals"][1]:
        fail(f"card and CPU disagree on detection counts: {err}")
    if err["sorted_scores_max_err"] > 1e-3 or err["mask_mean_err"] > 1e-3:
        fail(f"card and CPU disagree: {err}")


def profile_batch(run, out_path: Path, card: str) -> dict:
    """One traced batch: device time by kernel, and the device's busy share
    of the batch's wall time (union of kernel intervals over the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    return profile_summary(prof, wall_us, out_path, card)


def profile_summary(prof, wall_us: float, out_path: Path, card: str) -> dict:
    """A finished trace's device time by kernel and busy share of
    ``wall_us``, written to ``out_path`` with a host-operator table."""
    import torch

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        tot = by_name.setdefault(e.name, [0.0, 0])
        tot[0] += e.time_range.elapsed_us()
        tot[1] += 1
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for s, t in spans:
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    device_us = sum(v[0] for v in by_name.values())
    groups = {k: sum(v[0] for n, v in by_name.items() if k in n)
              for k in ("mmv_tf32x3_kernel", "split_tf32_kernel", "stem_kernel",
                        "roi_align_kernel", "roi_align_fused2_kernel",
                        "roi_align_backward_kernel", "Memcpy")}
    summary = {"card": card, "wall_ms": wall_us / 1e3, "kernel_ms": device_us / 1e3,
               "busy_ms": busy / 1e3, "idle_share": 1.0 - busy / wall_us if wall_us else None,
               "port_kernels_ms": {k: v / 1e3 for k, v in groups.items()},
               "n_kernel_launches": len(kernels)}
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    lines = [json.dumps(summary), f"{'ms':>10} {'calls':>6}  kernel"]
    lines += [f"{us / 1e3:10.3f} {n:6d}  {name[:150]}" for name, (us, n) in rows]
    lines += ["", "host: operators by self CPU time",
              prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=25)]
    out_path.write_text("\n".join(lines) + "\n")
    return summary


# ---------------------------------------------------------------------------
# the training path: harvest -> train -> serve


class _Anno:
    def __init__(self, boxes, labels, image_id):
        import numpy as np

        self.boxes, self.labels, self.image_id = boxes, labels, image_id
        self.difficult = np.zeros(len(labels), bool)


class SyntheticTeachingSet:
    """In-memory teaching images: noise with one coloured ellipse each, its
    box and mask; image i shows class i % classes + 1. Made with numpy from
    the seed, all at construction (set-up), so loading costs the harvest
    nothing but a copy. ``classes`` names the classes for the evaluator
    (index 0 is the background), and no object is difficult."""

    def __init__(self, n, hw, classes, seed, min_side=64, max_side=None):
        import numpy as np

        rng = np.random.default_rng(seed)
        h, w = hw
        self.classes = ("__background__",) + tuple(f"object_{c + 1}" for c in range(classes))
        self.images = rng.integers(0, 60, (n, h, w, 3), dtype=np.uint8)
        self.ids = [f"image_{i:04d}" for i in range(n)]
        self.boxes, self.labels, self.masks = [], [], []
        yy, xx = np.ogrid[:h, :w]
        for i in range(n):  # sides in [min_side, max_side), else up to 3/4 of the image's
            bw = int(rng.integers(min_side, max_side or w * 3 // 4))
            bh = int(rng.integers(min_side, max_side or h * 3 // 4))
            x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            ell = ((xx - x1 - bw / 2) / (bw / 2)) ** 2 + ((yy - y1 - bh / 2) / (bh / 2)) ** 2 <= 1
            cls = i % classes
            self.images[i][ell] = [(cls * 97) % 256, (cls * 57 + 80) % 256,
                                   (cls * 151 + 40) % 256]
            self.boxes.append(np.array([[x1, y1, x1 + bw, y1 + bh]], np.float32))
            self.labels.append(np.array([cls + 1]))
            self.masks.append(ell[None])

    def __len__(self):
        return len(self.images)

    def load_image(self, i):
        return self.images[i]

    def get_annotation(self, i):
        return _Anno(self.boxes[i], self.labels[i], self.ids[i])

    def load_masks(self, i, anno=None):
        return self.masks[i].astype("float32")


def teaching_set(n, seed):
    """n teaching (or, from another seed, held-out) images of TRAIN_HW whose
    objects' sides lie in OBJECT_SIDES."""
    return SyntheticTeachingSet(n, TRAIN_HW, N_CLASSES, seed, *OBJECT_SIDES)


def mining_launches(cfg, gt_cap, batch, mask_pix=64):
    """B1 launches of train_online_modules_device: one grouped launch per
    solver iteration per class window, for each minibootstrap head."""
    def windows(c):
        return -(-c // min(cfg.solver_class_chunk, c))

    seg_rows = 2 * cfg.segm_batch_size + gt_cap * batch * mask_pix  # mask pool + scratch
    seg_iters = -(-seg_rows // cfg.segm_batch_size)
    return (windows(cfg.num_anchor_classes) * cfg.iterations
            + windows(cfg.num_classes) * cfg.iterations + windows(cfg.num_classes) * seg_iters)


def harvest_inputs(params, ds, dcfg, dev, gt_cap=20):
    """The trunk's C4 map and the GT ++ proposal boxes of the first harvest
    batch: the inputs B4 gets on the harvest path."""
    import numpy as np
    import torch

    from online_detection_tpu_torch.data.transforms import normalize_canvas
    from online_detection_tpu_torch.models import resnet
    from online_detection_tpu_torch.models.anchors import grid_anchors
    from online_detection_tpu_torch.models.detector import rpn_scores_deltas
    from online_detection_tpu_torch.models.rpn import propose, rpn_features

    h, w = CANVAS
    images = torch.from_numpy(np.stack([ds.load_image(i) for i in range(BATCH_SIZE)])).to(dev)
    gt = torch.zeros((BATCH_SIZE, gt_cap, 4), device=dev)
    gt[:, 0] = torch.from_numpy(np.stack([ds.get_annotation(i).boxes[0]
                                          for i in range(BATCH_SIZE)])).to(dev)
    sizes = torch.tensor([[w, h]] * BATCH_SIZE, dtype=torch.float32, device=dev)
    anchors = torch.from_numpy(grid_anchors(h // 16, w // 16)).to(dev)
    c4 = resnet.backbone_c4(params.backbone, normalize_canvas(images).to(torch.bfloat16))
    scores, deltas = rpn_scores_deltas(params.rpn, None, rpn_features(params.rpn, c4))
    props, _, _ = propose(scores, deltas, anchors, sizes, dcfg.pre_nms_top_n,
                          dcfg.post_nms_top_n, dcfg.rpn_nms_thresh, dcfg.rpn_min_size)
    return c4, torch.cat([gt, props], dim=1)


def check_fused2(c4, rois, report):
    """B4 against its plain version (bf16 and f32), timed beside B3 and the
    plain version on the same inputs; its bound is B3's formula."""
    from online_detection_tpu_torch.ops.roi_align import (
        roi_align_batched, roi_align_fused2, roi_align_fused2_reference)

    got, ref = roi_align_fused2(c4, rois), roi_align_fused2_reference(c4, rois)
    check_close("roi_align_fused2", got, ref,
                bf16_ulp(ref.float()) + 1e-5 * ref.float().abs().max(), report)
    c4f = c4.float()
    ref32 = roi_align_fused2_reference(c4f, rois)
    check_close("roi_align_fused2", roi_align_fused2(c4f, rois), ref32,
                1e-5 * ref32.abs().max(), report)
    ms = timed(lambda: roi_align_fused2(c4, rois), 10)
    plain = timed(lambda: roi_align_fused2_reference(c4, rois), 3)
    b3_ms = timed(lambda: roi_align_batched(c4, rois), 10)
    b, h, w, c = c4.shape
    flops = roi_ops(rois, h, w, c)
    nbytes = 2.0 * (c4.numel() + got.numel()) + 4.0 * rois.numel()
    bound, by = bound_of(flops, nbytes)
    report["roi_align_fused2"].update(
        ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
        b3_same_inputs_ms=b3_ms, shape=list(got.shape), replaced_ms=REPLACED_ROI_MS["harvest"],
        tolerance="bf16: 1 ulp + 1e-5 max|ref|; f32: 1e-5 max|ref|")
    print(f"  roi_align_fused2[harvest] {list(got.shape)} bf16: {ms:.3f} ms (replaced kernel "
          f"{REPLACED_ROI_MS['harvest']:.3f} ms; plain {plain:.3f} ms; B3 on the same inputs "
          f"{b3_ms:.3f} ms; bound {bound:.3f} ms, {by}: {bound / ms:.0%} of it)", flush=True)


def check_mmv_mining(online, cfg, report, rng):
    """B1 at the minibootstrap's last mining pass of a class window:
    [chunk, N, d] rows drawn next to each class's trained centers (the
    hardest case for the cancelled cross term). The window takes the first
    classes that were trained: an untrained class's centers are not finite."""
    import torch

    from online_detection_tpu_torch.solvers.falkon import FalkonModel

    chunk = cfg.solver_class_chunk
    seg_rows = -(-(2 * cfg.segm_batch_size + 20 * BATCH_SIZE * 64) // cfg.segm_batch_size)
    heads = (("mining rpn", online.rpn.falkon, cfg.iterations * cfg.batch_size),
             ("mining detector", online.detector.falkon, cfg.iterations * cfg.batch_size),
             ("mining mask", online.mask.falkon, seg_rows * cfg.segm_batch_size))
    for role, fm, n in heads:
        keep = torch.nonzero(fm.exists).flatten()[:chunk]
        window = FalkonModel(fm.centers[keep].contiguous(), fm.alpha[keep].contiguous(),
                             fm.exists[keep], fm.sigma)
        g, m, d = window.centers.shape
        pick = torch.from_numpy(rng.integers(0, m, size=(g, n))).to(window.centers.device)
        x = window.centers.gather(1, pick[..., None].expand(g, n, d))
        x = x + torch.randn(x.shape, device=x.device) * (0.5 * fm.sigma / d ** 0.5)
        check_mmv_call(role, x, window, None, report, iters=3, plain_iters=2)
        del x, pick


def check_trained(online, counts, cfg):
    """Finite models; a head's class exists exactly where its pools had both
    positives and negatives; every detector class was taught."""
    import torch

    heads = {"rpn": (online.rpn, "rpn_pos", "rpn_neg"),
             "detector": (online.detector, "det_pos", "det_neg"),
             "mask": (online.mask, "mask_pos", "mask_neg")}
    summary = {}
    for name, (m, pos, neg) in heads.items():
        f = m.falkon
        for k, t in (("centers", f.centers), ("alpha", f.alpha), ("mean", m.stats.mean),
                     ("mean_norm", m.stats.mean_norm)):
            if not torch_isfinite(t):
                fail(f"{name} {k} is not finite")
        want = (counts[pos] > 0) & (counts[neg] > 0)
        if name == "detector":  # positives come from the COXY rows, per class
            want = counts["det_coxy_classes"] & (counts[neg] > 0)
        got = f.exists.cpu()
        if not torch.equal(got, want):
            fail(f"{name} exists {got.tolist()}, expected {want.tolist()}")
        summary[name] = int(got.sum())
        rls = getattr(m, "rls", None)
        if rls is not None and not (torch_isfinite(rls.beta) and torch_isfinite(rls.t_inv)):
            fail(f"{name} RLS model is not finite")
    if summary["detector"] != cfg.num_classes:
        fail(f"only {summary['detector']} of {cfg.num_classes} detector classes trained")
    return summary


def pool_counts(state, cfg):
    """Per-class counts of the harvested pools (host reads, after harvest)."""
    import torch

    counts = {k: getattr(state, k).counts.cpu() for k in
              ("rpn_pos", "rpn_neg", "det_pos", "det_neg", "mask_pos", "mask_neg")}
    packed = state.det_coxy.rows[0]
    valid = state.det_coxy.valid_mask()[0]
    labels = packed[:, -1].long()[valid].cpu()
    counts["det_coxy_classes"] = torch.zeros(cfg.num_classes, dtype=torch.bool)
    counts["det_coxy_classes"][(labels - 1).clamp(0, cfg.num_classes - 1)] = True
    return counts


def training_phase(params, seed, card, report, out_dir):
    """harvest_dataset_device -> train_online_modules_device -> one
    detect_batched batch with the trained models, each path's launch counts
    read right after it."""
    import numpy as np
    import torch

    from online_detection_tpu_torch.models.anchors import grid_anchors
    from online_detection_tpu_torch.models.detector import DetectorConfig, detect_batched
    from online_detection_tpu_torch.ops import _build
    from online_detection_tpu_torch.pipelines.device_pipeline import (
        harvest_dataset_device, train_online_modules_device)
    from online_detection_tpu_torch.pipelines.online_pipeline import OnlineTrainConfig

    cfg, dcfg = OnlineTrainConfig(), DetectorConfig()
    ds = teaching_set(TRAIN_IMAGES, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_batches = -(-TRAIN_IMAGES // BATCH_SIZE)
    paths = {}

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.time()
    state, meta = harvest_dataset_device(gen, params, ds, cfg, CANVAS, dcfg=dcfg,
                                         batch_size=BATCH_SIZE)
    torch.cuda.synchronize()
    harvest_s = time.time() - t0
    paths["harvest"] = dict(_build.LAUNCHES)
    want = {"gaussian_mmv": 0, "tf32_split": 0, "stem_pool": n_batches, "roi_align": 0,
            "roi_align_fused2": n_batches, "roi_align_backward": 0}
    if paths["harvest"] != want:
        fail(f"harvest launched {paths['harvest']}, expected {want}")
    counts = pool_counts(state, cfg)
    print(f"harvest_dataset_device {TRAIN_IMAGES} images of {TRAIN_HW[1]}x{TRAIN_HW[0]} at "
          f"batch {BATCH_SIZE}: {harvest_s:.3f} s, {harvest_s / TRAIN_IMAGES * 1e3:.2f} ms/image "
          f"on {card}; AR {meta['average_recall']:.4f}, truncation {meta['truncation']}",
          flush=True)

    state_copy, draws = clone_reservoirs(state), gen.get_state()  # for the plain-B1 run
    _build.reset_launches()
    stages = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    online = train_online_modules_device(gen, [state], cfg, timings=stages)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    del state
    paths["train"] = dict(_build.LAUNCHES)
    mining = mining_launches(cfg, 20, BATCH_SIZE)
    want = {"gaussian_mmv": mining, "tf32_split": mining, "stem_pool": 0, "roi_align": 0,
            "roi_align_fused2": 0, "roi_align_backward": 0}
    if paths["train"] != want:
        fail(f"training launched {paths['train']}, expected {want}")
    trained = check_trained(online, counts, cfg)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"train_online_modules_device: {train_s:.3f} s; seconds by stage "
          f"{ {k: round(v, 3) for k, v in stages.items()} } on {card}; classes trained "
          f"{trained}; peak {peak_gb:.1f} GiB", flush=True)
    plain_b1 = plain_b1_training_check(state_copy, draws, cfg, online, seed)
    del state_copy

    h, w = CANVAS
    anchors = torch.from_numpy(grid_anchors(h // 16, w // 16)).cuda()
    images = torch.from_numpy(np.stack([ds.load_image(i) for i in range(BATCH_SIZE)])).cuda()
    sizes = torch.tensor([[w, h]] * BATCH_SIZE, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    _build.reset_launches()
    dets, masks, props, pvalid = detect_batched(params, online, anchors, images, sizes, dcfg,
                                                True)
    torch.cuda.synchronize()
    paths["serve"] = dict(_build.LAUNCHES)
    if paths["serve"] != EXPECTED_LAUNCHES:
        fail(f"serving the trained models launched {paths['serve']}, "
             f"expected {EXPECTED_LAUNCHES}")
    n_valid = check_detections(dets, masks, props, pvalid, BATCH_SIZE, dcfg)
    print(f"detect_batched with the trained models: {n_valid} valid detections", flush=True)

    # one harvest batch traced: the entry point on the first 8 images
    first = teaching_set(BATCH_SIZE, seed)
    profiled = profile_batch(
        lambda: harvest_dataset_device(gen, params, first, cfg, CANVAS, dcfg=dcfg,
                                       batch_size=BATCH_SIZE),
        out_dir / "harvest_profile.txt", card)
    print(f"profile of one harvest batch: {json.dumps(profiled)}", flush=True)

    report["training"] = {
        "card": card, "images": TRAIN_IMAGES, "harvest_s": harvest_s,
        "harvest_ms_per_image": harvest_s / TRAIN_IMAGES * 1e3, "train_s": train_s,
        "train_stage_s": stages, "peak_gib": peak_gb, "launches": paths,
        "classes_trained": trained, "average_recall": meta["average_recall"],
        "truncation": meta["truncation"], "valid_detections": n_valid,
        "harvest_profile": profiled, "plain_b1_training": plain_b1}
    return online, ds, paths


def plain_b1_training_check(state, draws, cfg, trained, seed):
    """The training phase's training once more, from a copy of its
    reservoirs and its generator state, with each mining pass scored by
    B1's plain version in IEEE fp32 in place of the kernel, the kernel run
    beside it on the same inputs and both held against the plain version
    in float64: the training a plain B1 gives. Held, whatever the draw: B1
    within 1e-5 of the sum of the terms' magnitudes of the float64 scores
    on every pass (fault C5: a kernel that summed all of d in one
    tensor-core accumulator reached 1.24e-5 on the detector's rows,
    ROADMAP.md section C), B1 and the fp32 plain version
    finite exactly where the float64 scores are, and the models' ``exists``
    and RLS (which no mining pass reaches) equal to the training phase's
    within MESH_TOL. Recorded for every pass: B1's and the fp32 plain
    version's largest distance from the float64 scores, and the scores
    that fall on the other side of a mining threshold from the float64
    score's, for B1 and for the fp32 plain version. Recorded, not held: the
    FALKON scores against the training phase's (the card's roundings move
    scores across a threshold even for the plain version, and the
    thresholds turn that into other models)."""
    import numpy as np
    import torch

    from online_detection_tpu_torch.ops.gaussian_mmv import mmv_reference
    from online_detection_tpu_torch.pipelines.device_pipeline import (
        train_online_modules_device)
    from online_detection_tpu_torch.solvers import minibootstrap
    from online_detection_tpu_torch.utils.device import ieee_fp32

    kernel = minibootstrap.mmv_grouped
    rec = {"calls": 0, "scores": 0, "max_abs_err": 0.0, "max_rel_to_terms": 0.0,
           "fp32_plain_max_rel_to_terms": 0.0, "passes_over_1e-5": 0, "not_finite": 0,
           "straddles": {"b1_vs_float64": 0, "fp32_plain_vs_float64": 0,
                         "b1_vs_fp32_plain": 0}, "per_pass": []}

    def shadowed(x, centers, v, sigma, set_idx=None):
        got = kernel(x, centers, v, sigma, set_idx)
        with ieee_fp32():
            plain = mmv_reference(x, centers, v, sigma, set_idx)
        x64, c64, v64 = x.double(), centers.double(), v.double()
        ref = mmv_reference(x64, c64, v64, sigma, set_idx)
        terms = mmv_reference(x64, c64, v64.abs(), sigma, set_idx)
        finite = torch.isfinite(ref)
        if not (torch.equal(torch.isfinite(got), finite)
                and torch.equal(torch.isfinite(plain), finite)):
            fail("the plain-B1 training: B1 or its fp32 plain version is finite where the "
                 "float64 plain version is not, or not where it is")
        terms = torch.where(finite, terms, 1.0).clamp(min=1e-30)
        err = torch.where(finite, (got - ref).abs(), 0.0)
        rel = float((err / terms).max())
        rel_plain = float((torch.where(finite, (plain - ref).abs(), 0.0) / terms).max())
        straddles = {k: sum(int(((a > t) != (b > t))[finite].sum())
                            for t in (cfg.hard_thresh, cfg.easy_thresh))
                     for k, a, b in (("b1_vs_float64", got, ref),
                                     ("fp32_plain_vs_float64", plain, ref),
                                     ("b1_vs_fp32_plain", got, plain))}
        rec["calls"] += 1
        rec["scores"] += int(finite.sum())
        rec["not_finite"] += int((~finite).sum())
        rec["max_abs_err"] = max(rec["max_abs_err"], float(err.max()))
        rec["max_rel_to_terms"] = max(rec["max_rel_to_terms"], rel)
        rec["fp32_plain_max_rel_to_terms"] = max(rec["fp32_plain_max_rel_to_terms"],
                                                 rel_plain)
        rec["passes_over_1e-5"] += rel > 1e-5
        for k, n in straddles.items():
            rec["straddles"][k] += n
        rec["per_pass"].append([list(x.shape), rel, rel_plain, straddles])
        return plain

    gen = torch.Generator(device="cuda")
    gen.set_state(draws)
    minibootstrap.mmv_grouped = shadowed
    try:
        t0 = time.time()
        online = train_online_modules_device(gen, [state], cfg)
        torch.cuda.synchronize()
        rec["s"] = time.time() - t0
    finally:
        minibootstrap.mmv_grouped = kernel
    if rec["calls"] == 0:
        fail("the plain-B1 training: no mining pass went through B1")
    rec["models"] = compare_models(
        online, trained, head_probes(trained, np.random.default_rng(seed + 7)),
        "the plain-B1 training against the training",
        fields=("rls mu", "rls beta", "rls t_inv"))
    print(f"  training with B1's plain version ({rec['s']:.3f} s): {rec['calls']} mining "
          f"passes, {rec['scores']} scores; B1's largest distance from the float64 scores "
          f"{rec['max_abs_err']:.3e}, {rec['max_rel_to_terms']:.2e} of sum |terms| (over "
          f"1e-5 in {rec['passes_over_1e-5']} passes; the fp32 plain version "
          f"{rec['fp32_plain_max_rel_to_terms']:.2e}); scores on the other side of a mining "
          f"threshold {json.dumps(rec['straddles'])}; {rec['not_finite']} not "
          f"finite in all three; models against the kernel's "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in rec['models'].items()})}",
          flush=True)
    if rec["passes_over_1e-5"]:
        fail(f"the plain-B1 training: B1 is {rec['max_rel_to_terms']:.3g} of sum |terms| from "
             f"the float64 scores, over 1e-5 in {rec['passes_over_1e-5']} of {rec['calls']} "
             f"mining passes")
    return rec


# ---------------------------------------------------------------------------
# the inference stage: run_inference and its VOC07 scoring


@contextlib.contextmanager
def timed_evaluate(seconds: list):
    """A context in which ``voc_eval.evaluate`` appends its seconds to
    ``seconds`` (host clock; the scoring runs on the host)."""
    from online_detection_tpu_torch.data.evaluation import voc_eval

    evaluate = voc_eval.evaluate

    def timed(*args, **kwargs):
        t0 = time.time()
        try:
            return evaluate(*args, **kwargs)
        finally:
            seconds.append(time.time() - t0)

    voc_eval.evaluate = timed
    try:
        yield
    finally:
        voc_eval.evaluate = evaluate


def check_map_values(results, where: str):
    """det and segm mAP@0.5 finite and within [0, 1]."""
    import math

    for k in ("det_map_0.5", "segm_map_0.5"):
        v = results[k]
        if not (math.isfinite(v) and 0.0 <= v <= 1.0):
            fail(f"{where}: {k} = {v}")


def inference_phase(params, trained, seed, card, report, out_dir):
    """``run_inference`` over HELD_OUT_IMAGES held-out 800x600 images with the
    trained models at batch 8, scored by VOC07 det and segm mAP@0.5; the
    launch counts are read right after it. One more call over one batch is
    traced."""
    import torch

    from online_detection_tpu_torch.models.detector import DetectorConfig
    from online_detection_tpu_torch.ops import _build
    from online_detection_tpu_torch.pipelines.online_pipeline import run_inference

    test_set = teaching_set(HELD_OUT_IMAGES, seed + 1)
    n_batches = -(-HELD_OUT_IMAGES // BATCH_SIZE)
    shutil.rmtree(out_dir / "inference", ignore_errors=True)  # result.txt appends
    eval_s = []
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.time()
    with timed_evaluate(eval_s):
        results, preds = run_inference(params, trained, test_set, CANVAS, DetectorConfig(),
                                       batch_size=BATCH_SIZE,
                                       output_dir=str(out_dir / "inference"))
    wall_s = time.time() - t0
    launches = dict(_build.LAUNCHES)
    want = {k: n_batches * v for k, v in EXPECTED_LAUNCHES.items()}
    if launches != want:
        fail(f"run_inference launched {launches}, expected {want}")
    if len(preds) != HELD_OUT_IMAGES:
        fail(f"run_inference gave {len(preds)} predictions for {HELD_OUT_IMAGES} images")
    check_map_values(results, "run_inference")
    n_dets = [len(p["labels"]) for p in preds]
    per_class = {k: [round(float(a), 4) for a in results[k][1:]]
                 for k in ("det_ap_0.5", "segm_ap_0.5")}
    print(f"run_inference {HELD_OUT_IMAGES} held-out images of {TRAIN_HW[1]}x{TRAIN_HW[0]} at "
          f"batch {BATCH_SIZE}: det mAP@0.5 {results['det_map_0.5']:.4f}, segm mAP@0.5 "
          f"{results['segm_map_0.5']:.4f}; {HELD_OUT_IMAGES / wall_s:.2f} images/s, "
          f"{wall_s / HELD_OUT_IMAGES * 1e3:.2f} ms/image (wall clock, loading and scoring "
          f"included), of it evaluate {sum(eval_s):.3f} s; {sum(n_dets)} detections; "
          f"launches {launches} on {card}", flush=True)
    print(f"  per-class AP@0.5 {json.dumps(per_class)}", flush=True)

    first = teaching_set(BATCH_SIZE, seed + 1)
    profiled = profile_batch(
        lambda: run_inference(params, trained, first, CANVAS, DetectorConfig(),
                              batch_size=BATCH_SIZE),
        out_dir / "inference_profile.txt", card)
    print(f"profile of run_inference over one batch: {json.dumps(profiled)}", flush=True)
    report["inference"] = {
        "card": card, "images": HELD_OUT_IMAGES, "batch": BATCH_SIZE,
        "det_map_0.5": results["det_map_0.5"], "segm_map_0.5": results["segm_map_0.5"],
        "per_class_ap": per_class, "wall_s": wall_s,
        "images_per_s": HELD_OUT_IMAGES / wall_s,
        "ms_per_image": wall_s / HELD_OUT_IMAGES * 1e3, "evaluate_s": sum(eval_s),
        "detections": n_dets, "launches": launches, "profile": profiled}
    return launches


def small_inference_reference_check(params, trained, seed, dev, report):
    """``run_inference`` with the trained models on 4 held-out images at a
    small canvas, on the card (kernels, fp32 trunk) and on the CPU (plain
    versions), with the detections and with the GT boxes substituted (the
    models were taught larger objects than these, so only the second mode
    scores above 0): the same valid detections per image, with the same
    labels (as sorted lists: near-equal scores may swap ranks), and det and
    segm mAP@0.5 within 1e-3."""
    from online_detection_tpu_torch.models.detector import DetectorConfig
    from online_detection_tpu_torch.pipelines.online_pipeline import run_inference

    h, w = 128, 192  # needs no resize at min_size 128, max_size 192
    ds = SyntheticTeachingSet(4, (h, w), N_CLASSES, seed + 1, min_side=24)
    dcfg = DetectorConfig(pre_nms_top_n=200, post_nms_top_n=50, detections_per_img=20,
                          compute_dtype="float32")

    cpu = (copy.deepcopy(params).to("cpu"), trained.to("cpu"))
    report["small_inference_reference"] = {}
    for mode, gt_boxes in (("detections", False), ("gt_boxes", True)):
        def run(device, p, o):
            return run_inference(p, o, ds, (h, w), dcfg, min_size=h, max_size=w, batch_size=4,
                                 eval_segm_with_gt_bboxes=gt_boxes, device=device)

        rg, pg = run(dev, params, trained)
        rc, pc = run("cpu", *cpu)
        err = {"n_valid": [[len(p["labels"]) for p in pg], [len(p["labels"]) for p in pc]],
               "labels_equal": all(sorted(a["labels"].tolist()) == sorted(b["labels"].tolist())
                                   for a, b in zip(pg, pc))}
        for k in ("det_map_0.5", "segm_map_0.5"):
            err[k] = [rg[k], rc[k]]
        report["small_inference_reference"][mode] = err
        print(f"  run_inference ({mode}), card vs CPU plain path on 4x{h}x{w}: {err}",
              flush=True)
        if err["n_valid"][0] != err["n_valid"][1] or not err["labels_equal"]:
            fail(f"card and CPU disagree on detections: {err}")
        for k in ("det_map_0.5", "segm_map_0.5"):
            if not abs(rg[k] - rc[k]) <= 1e-3:
                fail(f"card and CPU disagree on {k}: {err}")


def small_training_reference_check(params, dev, report):
    """Harvest and training on a few small canvases on the card (kernels) and
    on the CPU (plain versions), full-width network, the same draws from one
    CPU generator seed: the trained heads score probe rows alike and serve
    the same number of detections."""
    import numpy as np
    import torch

    from online_detection_tpu_torch.models.anchors import grid_anchors
    from online_detection_tpu_torch.models.detector import DetectorConfig, detect_batched
    from online_detection_tpu_torch.pipelines.device_pipeline import (
        harvest_dataset_device, train_online_modules_device)
    from online_detection_tpu_torch.pipelines.online_pipeline import OnlineTrainConfig
    from online_detection_tpu_torch.solvers.falkon import falkon_predict_classes
    from online_detection_tpu_torch.solvers.rls import rls_predict
    from online_detection_tpu_torch.utils.stats import zscore

    h, w = 192, 256
    ds = SyntheticTeachingSet(4, (h, w), N_CLASSES, 5, min_side=48)
    cfg = OnlineTrainConfig(det_m=64, rpn_m=64, segm_m=64, iterations=2, batch_size=64,
                            segm_batch_size=256, rpn_pos_cap=256, det_pos_cap=64,
                            coxy_cap=512, segm_pos_cap=256)
    dcfg = DetectorConfig(pre_nms_top_n=200, post_nms_top_n=20, detections_per_img=10,
                          compute_dtype="float32")
    anchors = grid_anchors(h // 16, w // 16)
    images = np.stack([ds.load_image(i) for i in range(2)])
    sizes = np.array([[w, h]] * 2, np.float32)
    probe_rng = np.random.default_rng(11)

    def run(device, p):
        gen = torch.Generator().manual_seed(3)  # CPU draws, moved to the device
        state, _ = harvest_dataset_device(gen, p, ds, cfg, (h, w), dcfg=dcfg, gt_cap=4,
                                          min_size=h, batch_size=2, device=device)
        online = train_online_modules_device(gen, [state], cfg, device=device)
        dets, _, _, _ = detect_batched(p, online, anchors, images, sizes, dcfg, True,
                                       device=device)
        return online.to("cpu"), dets.valid.cpu()

    og, vg = run(dev, params)
    oc, vc = run("cpu", copy.deepcopy(params).to("cpu"))
    err = {"n_valid": [int(vg.sum()), int(vc.sum())]}
    for name in ("rpn", "detector", "mask"):
        mg, mc = getattr(og, name), getattr(oc, name)
        x = torch.from_numpy(probe_rng.normal(size=(64, mg.falkon.centers.shape[-1]))
                             .astype(np.float32)) + mc.stats.mean
        sg = falkon_predict_classes(mg.falkon, zscore(x, mg.stats))
        sc = falkon_predict_classes(mc.falkon, zscore(x, mc.stats))
        err[f"{name}_exists_equal"] = bool(torch.equal(mg.falkon.exists, mc.falkon.exists))
        err[f"{name}_score_max_err"] = float((sg - sc).abs().max())
        if name != "mask":
            err[f"{name}_rls_max_err"] = float((rls_predict(mg.rls, x)
                                                - rls_predict(mc.rls, x)).abs().max())
    report["small_training_reference"] = err
    print(f"  training, card vs CPU plain path on 4x{h}x{w}: {err}", flush=True)
    if err["n_valid"][0] != err["n_valid"][1] or not all(
            v for k, v in err.items() if k.endswith("_exists_equal")):
        fail(f"card and CPU disagree on trained classes or detection counts: {err}")
    if max(v for k, v in err.items() if k.endswith("_max_err")) > 1e-2:
        fail(f"card and CPU trained heads disagree: {err}")


# ---------------------------------------------------------------------------
# the host route: harvest_dataset -> HarvestAccumulator -> train_online_modules


class FirstImages:
    """The first ``n`` images of a dataset (the same images, no new draws)."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n
        self.classes = ds.classes

    def __len__(self):
        return self.n

    def __getattr__(self, name):  # load_image, get_annotation, load_masks
        return getattr(self.ds, name)


def peak_rss_gib() -> float:
    """The host process's peak resident set so far (Linux: KiB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def host_mining_launches(cfg, seg_iters):
    """B1 launches of the host route's train_online_modules: every head
    trains all its classes in one chunk, one grouped launch an iteration;
    the segmenter's iteration count is what ``finalize`` gave its pools."""
    rpn = cfg.iterations if cfg.with_rpn else 0
    return rpn + cfg.iterations + (seg_iters if cfg.with_segmentation else 0)


def check_host_models(online):
    """Finite models wherever a class exists; every head trained a class."""
    summary = {}
    for name in ("rpn", "detector", "mask"):
        m = getattr(online, name)
        f, ok = m.falkon, m.falkon.exists
        for k, t in (("centers", f.centers[ok]), ("alpha", f.alpha[ok]), ("mean", m.stats.mean),
                     ("mean_norm", m.stats.mean_norm)):
            if not torch_isfinite(t):
                fail(f"host route: {name} {k} is not finite where the class exists")
        rls = getattr(m, "rls", None)
        if rls is not None and not torch_isfinite(rls.beta[rls.exists]):
            fail(f"host route: {name} RLS is not finite where the class exists")
        summary[name] = int(ok.sum())
        if summary[name] == 0:
            fail(f"host route: no {name} class trained")
    return summary


def host_route_phase(params, seed, card, report, out_dir):
    """``harvest_dataset`` over the TRAIN_IMAGES teaching images one at a time
    (B = 1), ``train_online_modules`` with the flagship configuration, then
    ``run_inference`` over the held-out images with those models; the launch
    counts of each path are read right after it."""
    import torch

    from online_detection_tpu_torch.models.detector import DetectorConfig
    from online_detection_tpu_torch.ops import _build
    from online_detection_tpu_torch.pipelines.online_pipeline import (
        OnlineTrainConfig, harvest_dataset, run_inference, train_online_modules)

    cfg, dcfg = OnlineTrainConfig(), DetectorConfig()
    ds = teaching_set(TRAIN_IMAGES, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    paths = {}

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.time()
    harvest = harvest_dataset(gen, params, ds, cfg, CANVAS, dcfg=dcfg, gt_cap=20)
    harvest_s = time.time() - t0
    paths["host harvest"] = dict(_build.LAUNCHES)
    want = {"gaussian_mmv": 0, "tf32_split": 0, "stem_pool": TRAIN_IMAGES, "roi_align": 0,
            "roi_align_fused2": TRAIN_IMAGES, "roi_align_backward": 0}
    if paths["host harvest"] != want:
        fail(f"host harvest launched {paths['host harvest']}, expected {want}")
    mb_per_image = harvest["host_bytes"] / TRAIN_IMAGES / 1e6
    rss_harvest = peak_rss_gib()
    seg_iters = harvest["mask"]["neg"].shape[1]
    finalize_s = harvest["finalize_time"]
    print(f"harvest_dataset {TRAIN_IMAGES} images of {TRAIN_HW[1]}x{TRAIN_HW[0]} at B = 1: "
          f"{harvest_s:.3f} s, {harvest_s / TRAIN_IMAGES * 1e3:.2f} ms/image, "
          f"{mb_per_image:.2f} MB copied to the host an image, finalize "
          f"{finalize_s:.3f} s, peak host RSS {rss_harvest:.2f} GiB on {card}; "
          f"AR {harvest['average_recall']:.4f}, truncation {harvest['truncation']}; launches "
          f"{paths['host harvest']}", flush=True)

    _build.reset_launches()
    stages = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    online = train_online_modules(gen, harvest, cfg, timings=stages)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    det_pools = harvest["det"]  # the facades' phase trains on them
    del harvest
    paths["host train"] = dict(_build.LAUNCHES)
    mining = host_mining_launches(cfg, seg_iters)
    want = {"gaussian_mmv": mining, "tf32_split": mining, "stem_pool": 0, "roi_align": 0,
            "roi_align_fused2": 0, "roi_align_backward": 0}
    if paths["host train"] != want:
        fail(f"host training launched {paths['host train']}, expected {want}")
    trained = check_host_models(online)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    rss_train = peak_rss_gib()
    print(f"train_online_modules: {train_s:.3f} s; seconds by stage "
          f"{ {k: round(v, 3) for k, v in stages.items()} } on {card}; classes trained "
          f"{trained}; peak {peak_gb:.2f} GiB on the card, peak host RSS {rss_train:.2f} GiB; "
          f"launches {paths['host train']}", flush=True)

    test_set = teaching_set(HELD_OUT_IMAGES, seed + 1)
    n_batches = -(-HELD_OUT_IMAGES // BATCH_SIZE)
    _build.reset_launches()
    t0 = time.time()
    results, _ = run_inference(params, online, test_set, CANVAS, dcfg, batch_size=BATCH_SIZE)
    infer_s = time.time() - t0
    paths["host run_inference"] = dict(_build.LAUNCHES)
    want = {k: n_batches * v for k, v in EXPECTED_LAUNCHES.items()}
    if paths["host run_inference"] != want:
        fail(f"run_inference with the host route's models launched "
             f"{paths['host run_inference']}, expected {want}")
    check_map_values(results, "host route run_inference")
    dev_maps = {k: report["inference"][k] for k in ("det_map_0.5", "segm_map_0.5")}
    print(f"run_inference with the host route's models on the {HELD_OUT_IMAGES} held-out "
          f"images: det mAP@0.5 {results['det_map_0.5']:.4f}, segm mAP@0.5 "
          f"{results['segm_map_0.5']:.4f} (device route's models in this run: det "
          f"{dev_maps['det_map_0.5']:.4f}, segm {dev_maps['segm_map_0.5']:.4f}); "
          f"{infer_s:.3f} s; launches {paths['host run_inference']} on {card}", flush=True)
    # four images traced: the device's time an image beside the loop's
    traced = 4
    profiled = profile_batch(
        lambda: harvest_dataset(gen, params, FirstImages(ds, traced), cfg, CANVAS, dcfg=dcfg,
                                gt_cap=20),
        out_dir / "host_harvest_profile.txt", card)
    loop_ms = (harvest_s - finalize_s) / TRAIN_IMAGES * 1e3
    print(f"host harvest: {loop_ms:.2f} ms an image in the per-image loop (finalize apart); "
          f"traced over {traced} images: device {profiled['kernel_ms'] / traced:.2f} ms an "
          f"image, {profiled['n_kernel_launches'] / traced:.0f} launches an image, copies "
          f"{profiled['port_kernels_ms']['Memcpy'] / traced:.2f} ms an image; "
          f"{json.dumps(profiled)}", flush=True)
    report["host_route"] = {
        "card": card, "images": TRAIN_IMAGES, "harvest_s": harvest_s,
        "harvest_ms_per_image": harvest_s / TRAIN_IMAGES * 1e3,
        "loop_ms_per_image": loop_ms, "harvest_profile": profiled,
        "host_mb_per_image": mb_per_image, "finalize_s": finalize_s, "train_s": train_s,
        "train_stage_s": stages, "peak_gib_card": peak_gb, "peak_rss_gib_harvest": rss_harvest,
        "peak_rss_gib_train": rss_train, "classes_trained": trained, "seg_iterations": seg_iters,
        "det_map_0.5": results["det_map_0.5"], "segm_map_0.5": results["segm_map_0.5"],
        "device_route_maps": dev_maps, "run_inference_s": infer_s, "launches": paths}
    return paths, det_pools, online


def _same_rows(got, want, what):
    import numpy as np

    if got.shape != want.shape or not np.array_equal(got, want):
        fail(f"feature cache: {what} differ after the round trip")


def _row_multiset(rows):
    """Rows as one sorted byte string each: equal for any permutation."""
    import numpy as np

    rows = np.ascontiguousarray(rows)
    return np.sort(rows.view(np.dtype((np.void, rows.dtype.itemsize * rows.shape[1]))).ravel())


def feature_cache_phase(params, seed, card, report):
    """``save_features`` of a host-route harvest of the first 8 teaching
    images, then ``load_features`` with the shuffle flags off (the pools
    must equal the saved valid rows) and on (each class's negatives must be
    a permutation of them); the cache directory is deleted afterwards."""
    import tempfile

    import numpy as np
    import torch

    from online_detection_tpu_torch.models.detector import DetectorConfig
    from online_detection_tpu_torch.ops import _build
    from online_detection_tpu_torch.pipelines.online_pipeline import (
        OnlineTrainConfig, harvest_dataset)
    from online_detection_tpu_torch.utils.checkpoint import load_features, save_features

    cfg = OnlineTrainConfig()
    n = BATCH_SIZE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    _build.reset_launches()
    harvest = harvest_dataset(gen, params, FirstImages(teaching_set(TRAIN_IMAGES, seed), n), cfg,
                              CANVAS, dcfg=DetectorConfig(), gt_cap=20)
    launches = dict(_build.LAUNCHES)
    if launches["stem_pool"] != n or launches["roi_align_fused2"] != n:
        fail(f"the cache phase's harvest launched {launches}")
    scratch = ROOT / ".bench"
    scratch.mkdir(exist_ok=True)
    cache = Path(tempfile.mkdtemp(prefix="feature_cache_", dir=scratch))
    try:
        t0 = time.time()
        save_features(str(cache), harvest)
        save_s = time.time() - t0
        mb = sum(p.stat().st_size for p in cache.rglob("*") if p.is_file()) / 1e6
        t0 = time.time()
        plain = load_features(str(cache))
        load_s = time.time() - t0
        t0 = time.time()
        shuffled = load_features(str(cache), det_shuffle_negatives=True,
                                 rpn_shuffle_negatives=True, iterations=cfg.iterations,
                                 batch_size=cfg.batch_size, rng=np.random.default_rng(seed))
        load_shuffled_s = time.time() - t0
    finally:
        shutil.rmtree(cache, ignore_errors=True)

    for head in ("rpn", "det", "mask"):
        saved, got, mixed = harvest[head], plain[head], shuffled[head]
        for c in range(saved["pos"].shape[0]):
            want_pos = saved["pos"][c][saved["pos_valid"][c]]
            _same_rows(got["pos"][c][got["pos_valid"][c]], want_pos, f"{head} positives {c}")
            _same_rows(mixed["pos"][c][mixed["pos_valid"][c]], want_pos,
                       f"{head} positives {c} (shuffle flags on)")
            batches = [saved["neg"][c, b][saved["neg_valid"][c, b]]
                       for b in range(saved["neg"].shape[1])]
            if head == "mask":  # one pooled batch, subsampled at ratio 1.0: all rows
                _same_rows(got["neg"][c, 0][got["neg_valid"][c, 0]],
                           np.concatenate(batches), f"mask negatives {c}")
                continue
            for b, rows in enumerate(batches):
                _same_rows(got["neg"][c, b][got["neg_valid"][c, b]], rows,
                           f"{head} negatives {c}/{b}")
            loaded = mixed["neg"][c][mixed["neg_valid"][c]]
            _same_rows(_row_multiset(loaded), _row_multiset(np.concatenate(batches)),
                       f"{head} negatives {c} as a set (shuffle flags on)")
        if "coxy" in saved:
            for k in ("X", "Y", "C"):
                _same_rows(got["coxy"][k], saved["coxy"][k], f"{head} COXY {k}")
    print(f"feature cache of {n} teaching images: {mb:.1f} MB of .npy, save {save_s:.3f} s, "
          f"load {load_s:.3f} s, load with the shuffle flags {load_shuffled_s:.3f} s on {card}; "
          f"pools equal, shuffled negatives a permutation of them", flush=True)
    report["feature_cache"] = {"card": card, "images": n, "mb": mb, "save_s": save_s,
                               "load_s": load_s, "load_shuffled_s": load_shuffled_s,
                               "launches": launches}
    return {"cache harvest": launches}


# the JAX CLI's smoke configuration (tests/test_experiment_cli.py) with the
# flagship's solver widths: M 1000/1000/500, sigma 50/15/10
CLI_FEAT_CFG = """
MODEL:
  WEIGHT: ""
  RPN:
    PRE_NMS_TOP_N_TEST: 150
    POST_NMS_TOP_N_TEST: 40
  MASK_ON: True
DATASETS:
  TRAIN: ("path:{root}::train",)
  TEST: ("path:{root}::test",)
INPUT:
  MIN_SIZE_TEST: 128
  MAX_SIZE_TEST: 320
MINIBOOTSTRAP:
  DETECTOR:
    NUM_CLASSES: 19
    ITERATIONS: 2
    BATCH_SIZE: 64
    SHUFFLE_NEGATIVES: True
SEGMENTATION:
  BATCH_SIZE: 256
EVALUATION:
  IOU_THRESHOLDS: (0.5,)
  USE_VOC07_METRIC: True
"""

CLI_ONLINE_CFG = """
NUM_CLASSES: 20
ONLINE_REGION_CLASSIFIER:
  MINIBOOTSTRAP:
    EASY_THRESH: -0.9
    HARD_THRESH: -0.7
  CLASSIFIER: {lambda: 0.00001, sigma: 15, M: 1000, kernel_type: 'gauss'}
REGION_REFINER:
  opts: {lambda: 1000}
ONLINE_SEGMENTATION:
  MINIBOOTSTRAP: {EASY_THRESH: -0.9, HARD_THRESH: -0.7}
  CLASSIFIER: {lambda: 0.000001, sigma: 10, M: 500, kernel_type: 'gauss'}
EVALUATION: {SCORE_THRESH: -2, NMS: 0.3, DETECTIONS_PER_IMAGE: 10}
RPN:
  ONLINE_REGION_CLASSIFIER:
    MINIBOOTSTRAP: {EASY_THRESH: -0.9, HARD_THRESH: -0.7}
    CLASSIFIER: {lambda: 0.001, sigma: 50, M: 1000, kernel_type: 'gauss'}
  REGION_REFINER:
    opts: {lambda: 0.01}
"""

# result.txt of the flagship CLI, in its order: the harvest's lines, the
# training stages', the totals', then run_inference's (a "truncated" line
# follows the AR line when a fixed cap dropped rows)
CLI_HARVEST_LINES = ["Detector's features extracted in", "Average Recall (AR)", ""]
CLI_TRAIN_LINES = ["RPN's Online Classifier training time",
                   "RPN's Online Region Refiner training time",
                   "Detector's Online Region Refiner training time", "",
                   "Detector's Online Classifier training time",
                   "Online Segmentation training time", "", "Total training time",
                   "Training time for the online modules", ""]
CLI_INFERENCE_HEAD = ["Average image testing time", "Detection mAP50"]


def result_keys(text):
    """result.txt's lines as their text before the first colon (blank lines
    stay blank), the optional "truncated" line left out."""
    keys = [ln.split(":")[0].strip() for ln in text.splitlines()]
    return [k for k in keys if k != "truncated"]


def cli_phase(card, report, out_dir):
    """The port's flagship CLI on an on-disk synthetic tree (PIL-written
    JPEGs and masks): the device route saving its models, the host route
    saving the feature caches, then training from those caches. Each run
    must write the CLI's result.txt lines and give finite mAPs, and the
    launch counters of the kernels its path runs must rise. Then the four
    other experiment CLIs on the same tree (``experiment_clis``). Returns
    the flagship runs' launches and theirs apart."""
    import math

    from online_detection_tpu_torch.data.datasets.synthetic import make_synthetic_icwt
    from online_detection_tpu_torch.experiments import run_experiment_online_rpn_ood_oos as cli
    from online_detection_tpu_torch.ops import _build

    work = ROOT / ".bench" / "cli_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    keep = out_dir / "cli"
    shutil.rmtree(keep, ignore_errors=True)
    keep.mkdir()
    all_kernels = set(ONLINE_COUNTERS)
    runs = (("device route", "device", ["--save_RPN_detector_segmentation_models"],
             all_kernels),
            ("host route, save features", "host",
             ["--save_RPN_detector_segmentation_features"], all_kernels),
            ("host route, load features", "host",
             ["--load_RPN_detector_segmentation_features"], all_kernels - {"roi_align_fused2"}),
            ("device route, --n_devices 1", "device_n1",
             ["--save_RPN_detector_segmentation_models", "--n_devices", "1"], all_kernels))
    paths, summary, texts = {}, {}, {}
    try:
        root = work / "ycbv_synth"
        t0 = time.time()
        make_synthetic_icwt(str(root), n_train=8, n_test=4, image_hw=(240, 320))
        (work / "feat.yaml").write_text(CLI_FEAT_CFG.format(root=root))
        (work / "online.yaml").write_text(CLI_ONLINE_CFG)
        tree_s = time.time() - t0
        for name, sub, flags, rising in runs:
            out = work / sub
            result = out / "result.txt"
            before = result.read_text() if result.exists() else ""
            _build.reset_launches()
            t0 = time.time()
            results = cli.main(["--output_dir", str(out),
                                "--config_file_feature_extraction", str(work / "feat.yaml"),
                                "--config_file_online_rpn_detection_segmentation",
                                str(work / "online.yaml")] + flags)
            run_s = time.time() - t0
            paths[f"cli {name}"] = launches = dict(_build.LAUNCHES)
            idle = sorted(k for k in rising if launches[k] == 0)
            if idle or any(launches[k] for k in all_kernels - rising):
                fail(f"CLI ({name}) launched {launches}: the kernels of its path must rise")
            texts[name] = text = result.read_text()[len(before):]
            (keep / f"{name.replace(' ', '_').replace(',', '').replace('-', '')}.txt"
             ).write_text(text)
            keys = result_keys(text)
            head = (CLI_HARVEST_LINES if "load" not in name else []) + CLI_TRAIN_LINES
            if keys[:len(head)] != head or keys[len(head):len(head) + 2] != CLI_INFERENCE_HEAD:
                fail(f"CLI ({name}) result.txt lines {keys}, expected {head} then "
                     f"{CLI_INFERENCE_HEAD}")
            maps = {k: results[k] for k in ("det_map_0.5", "segm_map_0.5")}
            if not all(math.isfinite(v) for v in maps.values()):
                fail(f"CLI ({name}) mAPs {maps}")
            summary[name] = {"seconds": run_s, "launches": launches, **maps}
            print(f"  CLI ({name}): {run_s:.2f} s, det mAP@0.5 {maps['det_map_0.5']:.4f}, "
                  f"segm mAP@0.5 {maps['segm_map_0.5']:.4f}, launches {launches} on {card}",
                  flush=True)
        # --n_devices 1 builds no mesh (as in the JAX CLI): the same run
        one, plain = summary["device route, --n_devices 1"], summary["device route"]
        same_lines = [ln for ln in texts["device route"].splitlines()
                      if "time" not in ln and "extracted" not in ln] == [
            ln for ln in texts["device route, --n_devices 1"].splitlines()
            if "time" not in ln and "extracted" not in ln]
        if not same_lines or any(one[k] != plain[k] for k in ("det_map_0.5", "segm_map_0.5")):
            fail("the CLI with --n_devices 1 wrote another result.txt than without it")
        new_paths = experiment_clis(work, card, keep, summary)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    report["cli"] = {"card": card, "tree_s": tree_s, "runs": summary}
    return paths, new_paths


# ---------------------------------------------------------------------------
# checkpoint files and the stock Mask R-CNN path

# COCO's classes and the background: the stock predictors of the Detectron
# R-50-C4 checkpoints
COCO_CLASSES = 81
PRETRAINED_IMAGES = 8


# the class logits' gain: at the random predictor's own scale no class
# reaches detect_pretrained's 0.05 score threshold on these images (one in
# 81); at 6x several classes do
CLS_GAIN = 6.0


def random_checkpoint(seed):
    """Full-width R-50-C4 with COCO's predictors (cls [2048, 81], bbox
    [2048, 324], mask logits [256, 81]), random from numpy seeds, on the CPU."""
    from online_detection_tpu_torch.experiments.weights_smoke import random_params

    params = random_params(seed, N_ANCHORS, COCO_CLASSES)
    params.box_predictor.cls_w *= CLS_GAIN
    return params


def canvases_of(ds, n):
    """The first n teaching images (600x800) as 608x800 uint8 canvases."""
    import numpy as np

    out = np.zeros((n,) + CANVAS + (3,), np.uint8)
    for i in range(n):
        img = ds.load_image(i)
        out[i, :img.shape[0], :img.shape[1]] = img
    return out


def detections_of(params, anchors, canvases, dev, with_masks=True):
    """``detect_pretrained`` on each canvas: (detections, masks) per image."""
    from online_detection_tpu_torch.models.detector import DetectorConfig, detect_pretrained

    h, w = TRAIN_HW
    return [detect_pretrained(params, anchors, c, (w, h), DetectorConfig(),
                              with_masks=with_masks, device=dev)[:2] for c in canvases]


def check_pretrained_detections(dets, masks, cfg):
    d, p = cfg.detections_per_img, cfg.pooler_resolution
    for k, got, want in (("boxes", dets.boxes.shape, (d, 4)), ("scores", dets.scores.shape, (d,)),
                         ("labels", dets.labels.shape, (d,)), ("masks", masks.shape, (d, p, p))):
        if tuple(got) != want:
            fail(f"detect_pretrained: {k} shape {tuple(got)}, expected {want}")
    for k, t in (("boxes", dets.boxes), ("scores", dets.scores), ("masks", masks)):
        if not torch_isfinite(t):
            fail(f"detect_pretrained: non-finite {k}")
    v = dets.valid
    if not bool(v.any()):
        fail("detect_pretrained: no valid detections")
    lab = dets.labels[v]
    if bool(((lab < 1) | (lab >= COCO_CLASSES)).any()):
        fail("detect_pretrained: labels out of range")
    if bool((dets.scores[v] <= 0.05).any()) or bool((dets.boxes[~v] != 0).any()):
        fail("detect_pretrained: a kept score under the threshold or a non-zero padding row")
    if bool(((masks < 0) | (masks > 1)).any()):
        fail("detect_pretrained: mask probabilities out of [0, 1]")
    return int(v.sum())


def check_pretrained_kernels(params, canvas, dets_boxes, report):
    """B2's fp32 route at the checksum shape and B3 at the stock path's
    shapes (bf16 proposals and detections on a 38 x 50 map; fp32 checksum
    boxes on an 8 x 10 map), held against their plain versions and timed."""
    import numpy as np
    import torch

    from online_detection_tpu_torch.data.transforms import normalize_canvas
    from online_detection_tpu_torch.models import resnet
    from online_detection_tpu_torch.models.anchors import grid_anchors
    from online_detection_tpu_torch.models.detector import rpn_scores_deltas
    from online_detection_tpu_torch.models.rpn import propose, rpn_features
    from online_detection_tpu_torch.ops.roi_align import roi_align_batched, roi_align_reference
    from online_detection_tpu_torch.ops.stem_pool import stem_fused, stem_reference

    st = params.backbone.stem
    args = (st.weight, st.scale, st.bias)
    h, w = 128, 160  # activation_checksums' image
    x = torch.from_numpy(np.random.default_rng(0).uniform(-120, 120, (1, h, w, 3))
                         .astype(np.float32)).cuda()
    got, ref = stem_fused(x, *args), stem_reference(x, *args)
    check_close("stem_pool", got, ref, 1e-5 * ref.abs().max(), report)
    ms, plain = timed(lambda: stem_fused(x, *args), 20), timed(lambda: stem_reference(x, *args), 5)
    h2, w2 = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    flops = 2.0 * h2 * w2 * 64 * 147
    nbytes = 4.0 * (x.numel() + got.numel() + st.weight.numel() + 128)
    bound, by = bound_of(flops, nbytes)  # the fp32 route runs on the CUDA cores
    report["stem_pool"]["f32_route"] = {
        "shape": list(x.shape), "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
        "max_abs_err": float((got - ref).abs().max()), "tolerance": "1e-5 max|ref|"}
    print(f"  stem_pool fp32 route at the checksum shape {list(x.shape)}: {ms:.4f} ms (plain "
          f"{plain:.3f} ms; bound {bound:.5f} ms, {by}: {bound / ms:.1%} of it)", flush=True)

    img = normalize_canvas(torch.from_numpy(canvas[None]).cuda())
    c4 = resnet.backbone_c4(params.backbone, img.to(torch.bfloat16))
    t = rpn_features(params.rpn, c4)
    s, d = rpn_scores_deltas(params.rpn, None, t)
    anchors = torch.from_numpy(grid_anchors(CANVAS[0] // 16, CANVAS[1] // 16)).cuda()
    size = torch.tensor([[TRAIN_HW[1], TRAIN_HW[0]]], dtype=torch.float32, device="cuda")
    props = propose(s, d, anchors, size)[0]
    c4_small = resnet.backbone_c4(params.backbone, x)
    small_boxes = torch.tensor([[[0.0, 0.0, w / 2, h / 2], [w / 4, h / 4, w - 1.0, h - 1.0]]],
                               device="cuda")
    calls = []
    for role, f, rois, bf16 in (("pretrained proposals", c4, props, True),
                                ("pretrained detections", c4, dets_boxes[None].contiguous(), True),
                                ("checksum boxes", c4_small, small_boxes, False)):
        got, ref = roi_align_batched(f, rois), roi_align_reference(f, rois)
        tol = 1e-5 * ref.float().abs().max()
        if bf16:
            tol = bf16_ulp(ref.float()) + tol
        check_close("roi_align", got, ref, tol, report)
        ms = timed(lambda: roi_align_batched(f, rois), 10)
        plain = timed(lambda: roi_align_reference(f, rois), 3)
        _, fh, fw, c = f.shape
        nbytes = f.element_size() * (f.numel() + got.numel()) + 4.0 * rois.numel()
        bound, by = bound_of(roi_ops(rois, fh, fw, c), nbytes)
        calls.append({"role": role, "shape": list(got.shape), "dtype": str(f.dtype), "ms": ms,
                      "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                      "max_abs_err": float((got.float() - ref.float()).abs().max())})
        print(f"  roi_align[{role}] {list(got.shape)} {str(f.dtype).split('.')[-1]}: {ms:.4f} ms "
              f"(plain {plain:.3f} ms; bound {bound:.4f} ms, {by}: {bound / ms:.0%} of it)",
              flush=True)
    report["roi_align"]["pretrained_calls"] = calls


def small_pretrained_reference_check(params, dev, report):
    """``detect_pretrained`` on the card (kernels, fp32 trunk) against the
    CPU (plain versions) on a small canvas, full-width network with COCO's
    predictors: the same number of detections and proposals, sorted scores
    within 1e-3 (near-equal scores may swap places), mean mask within 1e-3."""
    import numpy as np

    from online_detection_tpu_torch.models.anchors import grid_anchors
    from online_detection_tpu_torch.models.detector import DetectorConfig, detect_pretrained

    rng = np.random.default_rng(321)
    h, w = 128, 192
    image = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    anchors = grid_anchors(h // 16, w // 16)
    cfg = DetectorConfig(pre_nms_top_n=200, post_nms_top_n=50, detections_per_img=20,
                         compute_dtype="float32")

    def run(device, p):
        dets, masks, _, pvalid = detect_pretrained(p, anchors, image, (w - 24, h - 16), cfg,
                                                   with_masks=True, device=device)
        return dets.scores.cpu(), dets.valid.cpu(), masks.cpu(), pvalid.cpu()

    sg, vg, mg, pg = run(dev, params)
    sc, vc, mc, pc = run("cpu", copy.deepcopy(params).to("cpu"))
    err = {"n_valid": [int(vg.sum()), int(vc.sum())],
           "n_proposals": [int(pg.sum()), int(pc.sum())],
           "sorted_scores_max_err": float((sg.sort(-1).values - sc.sort(-1).values).abs().max()),
           "mask_mean_err": float((mg.mean() - mc.mean()).abs())}
    report["pretrained"]["small_reference"] = err
    print(f"  detect_pretrained, card vs CPU plain path on {h}x{w}: {err}", flush=True)
    if err["n_valid"][0] != err["n_valid"][1] or err["n_proposals"][0] != err["n_proposals"][1]:
        fail(f"detect_pretrained: card and CPU disagree on counts: {err}")
    if err["sorted_scores_max_err"] > 1e-3 or err["mask_mean_err"] > 1e-3:
        fail(f"detect_pretrained: card and CPU disagree: {err}")


def pretrained_phase(seed, card, report, out_dir):
    """Checkpoint files and the stock path: random full-width weights with
    COCO's predictors written as a Caffe2 .pkl and a .pth ("model" key,
    ``module.`` prefixes) by the port's exporters, loaded onto the card
    (checksums of the original and both reloads within rtol 1e-5),
    ``detect_pretrained`` with masks on PRETRAINED_IMAGES canvases one at a
    time (B2 +1 and B3 +2 an image), one traced image, the card against the
    CPU on a small canvas, checkpoints A, B, A loaded in turn (A's
    detections must come back), then the tester CLI over both files,
    ``weights_smoke --selftest`` and a flagship CLI run with ``--weights``."""
    import math

    import torch

    from online_detection_tpu_torch.data.datasets.synthetic import make_synthetic_icwt
    from online_detection_tpu_torch.experiments import run_experiment_online_rpn_ood_oos as cli
    from online_detection_tpu_torch.experiments import run_experiment_test_feature_task as tester
    from online_detection_tpu_torch.experiments import weights_smoke
    from online_detection_tpu_torch.models.anchors import grid_anchors
    from online_detection_tpu_torch.models.detector import DetectorConfig, detect_pretrained
    from online_detection_tpu_torch.models.weights import activation_checksums, load_checkpoint
    from online_detection_tpu_torch.ops import _build

    dev = torch.device("cuda")
    work = ROOT / ".bench" / "pretrained"
    shutil.rmtree(work, ignore_errors=True)
    (work / "models").mkdir(parents=True)
    rec = report.setdefault("pretrained", {"card": card})
    paths = {}
    try:
        t0 = time.time()
        params_a = random_checkpoint(seed + 5)
        pkl, pth = weights_smoke.write_checkpoints(params_a, str(work / "models"), "model_a")
        pkl_b, _ = weights_smoke.write_checkpoints(random_checkpoint(seed + 6), str(work), "b")
        write_s = time.time() - t0
        file_mb = {Path(f).name: Path(f).stat().st_size / 1e6 for f in (pkl, pth)}

        _build.reset_launches()
        sums = {"original": activation_checksums(params_a.to(dev))}
        load_s = {}
        for name, path in (("caffe2_pkl", pkl), ("torch_pth", pth)):
            t0 = time.time()
            loaded = load_checkpoint(path).to(dev)
            torch.cuda.synchronize()
            load_s[name] = time.time() - t0
            sums[name] = activation_checksums(loaded)
            weights_smoke.compare_checksums(sums["original"], sums[name], name)
        del loaded
        paths["checksums"] = launches = dict(_build.LAUNCHES)
        if launches["stem_pool"] != 3 or launches["roi_align"] != 3:
            fail(f"three checksum passes launched {launches}: B2 and B3 must rise by 3 each")
        print(f"checkpoint files: wrote {file_mb} MB in {write_s:.2f} s; loaded onto the card in "
              f"{ {k: round(v, 3) for k, v in load_s.items()} } s; checksums of the original "
              f"and both reloads agree (rtol 1e-5) on {card}:", flush=True)
        for stage, r in sums["original"].items():
            print(f"  {stage}: {json.dumps(r)}", flush=True)

        ds = teaching_set(PRETRAINED_IMAGES, seed + 3)
        canvases = canvases_of(ds, PRETRAINED_IMAGES)
        anchors = torch.from_numpy(grid_anchors(CANVAS[0] // 16, CANVAS[1] // 16)).to(dev)
        cfg = DetectorConfig()
        h, w = TRAIN_HW
        torch.cuda.synchronize()
        _build.reset_launches()
        times, n_valid = [], []
        for c in canvases:
            t0 = time.time()
            dets, masks, _, _ = detect_pretrained(params_a, anchors, c, (w, h), cfg,
                                                  with_masks=True, device=dev)
            torch.cuda.synchronize()
            times.append((time.time() - t0) * 1e3)
            n_valid.append(check_pretrained_detections(dets, masks, cfg))
        paths["detect_pretrained"] = launches = dict(_build.LAUNCHES)
        want = {"gaussian_mmv": 0, "tf32_split": 0, "stem_pool": PRETRAINED_IMAGES,
                "roi_align": 2 * PRETRAINED_IMAGES, "roi_align_fused2": 0,
                "roi_align_backward": 0}
        if launches != want:
            fail(f"detect_pretrained launched {launches}, expected {want}")
        steady = times[1:]
        print(f"detect_pretrained with masks, {PRETRAINED_IMAGES} canvases of {CANVAS[1]}x"
              f"{CANVAS[0]} one at a time: ms an image {[round(t, 2) for t in times]} (steady "
              f"mean {sum(steady) / len(steady):.2f}); valid detections {n_valid}; launches "
              f"{launches} on {card}", flush=True)
        profiled = profile_batch(
            lambda: detect_pretrained(params_a, anchors, canvases[0], (w, h), cfg,
                                      with_masks=True, device=dev),
            out_dir / "pretrained_profile.txt", card)
        print(f"profile of one detect_pretrained image: {json.dumps(profiled)}", flush=True)
        check_pretrained_kernels(params_a, canvases[0], dets.boxes, report)
        rec.update(write_s=write_s, file_mb=file_mb, load_s=load_s, checksums=sums["original"],
                   ms_per_image=times, valid_detections=n_valid, profile=profiled)
        small_pretrained_reference_check(params_a, dev, report)
        del params_a
        torch.cuda.empty_cache()

        # A, B, A: a checkpoint loaded after another gives its own results
        runs = []
        for path in (pkl, pkl_b, pkl):
            p = load_checkpoint(path).to(dev)
            runs.append(detections_of(p, anchors, canvases[:2], dev))
            del p
        same = all(torch.equal(a.labels, b.labels) and torch.equal(a.valid, b.valid)
                   and float((a.scores - b.scores).abs().max()) <= 1e-6
                   and float((a.boxes - b.boxes).abs().max()) <= 1e-4
                   and float((ma - mb).abs().max()) <= 1e-6
                   for (a, ma), (b, mb) in zip(runs[0], runs[2]))
        bitwise = all(torch.equal(a.scores, b.scores) and torch.equal(a.boxes, b.boxes)
                      for (a, _), (b, _) in zip(runs[0], runs[2]))
        differs = any(not torch.equal(a.scores, b.scores) for (a, _), (b, _) in
                      zip(runs[0], runs[1]))
        rec["reload_a_b_a"] = {"a_again_equal": same, "a_again_bitwise": bitwise,
                               "b_differs": differs}
        print(f"  checkpoints A, B, A in one process: A's detections again {same} (bit for "
              f"bit {bitwise}), B's differ {differs}", flush=True)
        if not same or not differs:
            fail(f"A-B-A reload: A again equal {same}, B differs {differs}")

        root = work / "ycbv_synth"
        make_synthetic_icwt(str(root), n_train=8, n_test=4, image_hw=(240, 320))
        (work / "feat.yaml").write_text(CLI_FEAT_CFG.format(root=root))
        (work / "online.yaml").write_text(CLI_ONLINE_CFG)
        _build.reset_launches()
        t0 = time.time()
        results = tester.main(["--output_dir", str(work / "tester"), "--models_dir",
                               str(work / "models"), "--config_file", str(work / "feat.yaml")])
        tester_s = time.time() - t0
        paths["tester"] = launches = dict(_build.LAUNCHES)
        names = sorted(Path(k).name for k in results)
        maps = {Path(k).name: {m: r[m] for m in ("det_map_0.5", "segm_map_0.5")}
                for k, r in results.items()}
        if names != ["model_a.pkl", "model_a.pth"] or not all(
                math.isfinite(v) for r in maps.values() for v in r.values()):
            fail(f"tester CLI: {maps}")
        if launches["stem_pool"] != 8 or launches["roi_align"] != 16:
            fail(f"tester CLI over 2 checkpoints x 4 images launched {launches}")
        print(f"tester CLI over {names} x 4 test images: {tester_s:.2f} s; mAPs {maps}; "
              f"launches {launches} on {card}", flush=True)

        _build.reset_launches()
        t0 = time.time()
        weights_smoke.main(["--selftest"])
        selftest_s = time.time() - t0
        paths["weights_smoke selftest"] = dict(_build.LAUNCHES)
        print(f"weights_smoke --selftest on the card: {selftest_s:.2f} s", flush=True)

        _build.reset_launches()
        t0 = time.time()
        out = work / "flagship"
        flag = cli.main(["--output_dir", str(out), "--config_file_feature_extraction",
                         str(work / "feat.yaml"), "--config_file_online_rpn_detection_segmentation",
                         str(work / "online.yaml"), "--weights", pkl])
        flag_s = time.time() - t0
        paths["cli --weights"] = launches = dict(_build.LAUNCHES)
        keys = result_keys((out / "result.txt").read_text())
        head = CLI_HARVEST_LINES + CLI_TRAIN_LINES
        if keys[:len(head)] != head or keys[len(head):len(head) + 2] != CLI_INFERENCE_HEAD:
            fail(f"CLI with --weights: result.txt lines {keys}")
        flag_maps = {k: flag[k] for k in ("det_map_0.5", "segm_map_0.5")}
        if not all(math.isfinite(v) for v in flag_maps.values()) or any(
                launches[k] == 0 for k in ONLINE_COUNTERS):
            fail(f"CLI with --weights: mAPs {flag_maps}, launches {launches}")
        print(f"flagship CLI (device route) with --weights {Path(pkl).name}: {flag_s:.2f} s, "
              f"mAPs {flag_maps}, launches {launches} on {card}", flush=True)
        rec.update(tester_s=tester_s, tester_maps=maps, selftest_s=selftest_s,
                   cli_weights_s=flag_s, cli_weights_maps=flag_maps)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec["launches"] = paths
    return paths


# ---------------------------------------------------------------------------
# the SGD baselines: full training and fine-tuning from cached backbone maps

SGD_IMAGES, SGD_STEPS, FT_STEPS = 8, 16, 8
# the step traced with torch.profiler (its time stays out of the median)
SGD_TRACED_STEP = 14
# the CLIs' tree and solver config (the SGD test config of
# tests/test_experiment_cli_all.py, full width)
CLI_SGD_CFG = CLI_FEAT_CFG.replace("  MASK_ON: True", """    POST_NMS_TOP_N_TRAIN: 30
  ROI_HEADS:
    BATCH_SIZE_PER_IMAGE: 32
  MASK_ON: True""").replace("EVALUATION:", """SOLVER:
  BASE_LR: 0.005
  WARMUP_ITERS: 0
  STEPS: (48000, 64000)
  WEIGHT_DECAY: 0.0005
EVALUATION:""")


def sgd_params(seed):
    """Full-width R-50-C4 from a numpy seed, 15 anchors, mask head, its
    predictors re-initialised for 22 classes as the SGD CLIs do, on the CPU."""
    from online_detection_tpu_torch.experiments._common import reinit_predictors
    from online_detection_tpu_torch.models.detector import init_detector_params

    return reinit_predictors(init_detector_params(seed, N_ANCHORS, N_CLASSES + 1), N_CLASSES,
                             True)


def leaves_of(params):
    """JAX path -> a CPU copy of each tensor."""
    from online_detection_tpu_torch.engine.trainer import named_leaves

    return {p: t.detach().cpu().clone() for p, t in named_leaves(params)}


def step_inputs(params, ds, cfg, dev, gen):
    """One full-train step's RoIAlign inputs, as ``training_loss`` makes
    them: the C4 map [1, 38, 50, 1024] f32 of the first image and the
    ``roi_batch`` sampled boxes [1, 512, 4] (proposals and GT)."""
    import torch

    from online_detection_tpu_torch.data.transforms import normalize_canvas
    from online_detection_tpu_torch.engine import losses
    from online_detection_tpu_torch.engine.trainer import host_batch
    from online_detection_tpu_torch.models import resnet
    from online_detection_tpu_torch.models.anchors import grid_anchors
    from online_detection_tpu_torch.models.rpn import propose, rpn_features, rpn_pretrained

    anchors_np = grid_anchors(CANVAS[0] // 16, CANVAS[1] // 16)
    host = host_batch(ds, 0, CANVAS, TRAIN_HW[0], 1333, 20, anchors_np, False, 0.0, None,
                       False)
    b = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    c4 = resnet.backbone_c4(params.backbone, normalize_canvas(b["image"])[None])
    logits, deltas = rpn_pretrained(params.rpn, rpn_features(params.rpn, c4))
    boxes, _, valid = propose(logits.reshape(1, -1), deltas.reshape(1, -1, 4),
                              torch.from_numpy(anchors_np).to(dev), b["image_size"][None],
                              post_nms_top_n=cfg.post_nms_train)
    sample = losses.sample_rois(torch.cat([boxes[0], b["gt_boxes"]]),
                                torch.cat([valid[0], b["gt_valid"]]), b["gt_boxes"],
                                b["gt_labels"], b["gt_valid"], cfg.roi_batch, generator=gen)
    return c4.contiguous(), sample.boxes[None].contiguous()


def backward_stress_rois(rng, r, h, w):
    """The backward kernel's other layouts onto an [h, w] map at stride 16,
    [1, n, 4] boxes each: ``r`` copies of one box (every RoI's atomics on
    the same cells); 64 boxes past the whole map with bins over 7 cells a
    side (8 samples per bin and axis, every cell touched: the widest
    footprint); ``r`` adversarial boxes (``adversarial_rois``); and ``r``
    boxes of the teaching set's object sizes (sides in OBJECT_SIDES, wholly
    on the map), as a trained RPN proposes around objects."""
    import numpy as np

    one = np.tile(np.array([[[200.0, 150.0, 420.0, 380.0]]], np.float32), (1, r, 1))
    lo = -rng.uniform(0, 400, size=(64, 2))
    hi = np.array([w, h]) * 16.0 + rng.uniform(1700, 2400, size=(64, 2))
    side = rng.uniform(*OBJECT_SIDES, size=(r, 2))
    corner = rng.uniform(0, 1, size=(r, 2)) * (np.array([w, h]) * 16.0 - side)
    return {"one box x512": one,
            "whole map x64": np.concatenate([lo, hi], -1)[None].astype(np.float32),
            "adversarial x512": adversarial_rois(rng, 1, r, 16.0 * w),
            "object-sized x512": np.concatenate([corner, corner + side], -1)[None].astype(
                np.float32)}


def start_replaced_backward(_build):
    """Starts nvcc on the RoIAlign backward kernel that
    ``csrc/roi_align_backward.cu`` replaced (``REPLACED_BACKWARD_SOURCE``)
    into the build directory: (process, library)."""
    d = _build.BUILD_DIR / "replaced"
    d.mkdir(parents=True, exist_ok=True)
    so = d / "libroi_align_backward_replaced.so"
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                             str(so), str(REPLACED_BACKWARD_SOURCE)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def load_replaced_backward(started, _build):
    """Waits for ``start_replaced_backward``'s build and returns a function
    (g, rois, h, w) -> dF that zeroes a map and launches that kernel on it,
    as the port's wrapper does its own (no launch count), and nvcc's log."""
    import ctypes

    import torch

    proc, so = started
    log, _ = proc.communicate()
    if proc.returncode:
        fail(f"nvcc failed for {REPLACED_BACKWARD_SOURCE.name}:\n{log}")
    fn = ctypes.CDLL(str(so)).odt_roi_align_backward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]

    def run(g, rois, h, w):
        b, r, p, _, c = g.shape
        out = torch.zeros((b, h, w, c), device=g.device, dtype=torch.float32)
        _build.check(fn(g.data_ptr(), rois.data_ptr(), out.data_ptr(), b, r, h, w, c, p,
                        1.0 / 16.0, torch.cuda.current_stream(g.device).cuda_stream),
                     "the replaced RoIAlign backward kernel")
        return out
    return run, log


# shapes the wrapper admits beyond the training step's: (b, r, pooled, h, w, c),
# among them a ragged last channel tile, pooled rows in several slabs (pooled >
# 16) at the largest map, and one channel vector
BACKWARD_SHAPES = ((2, 40, 7, 50, 84, 256), (1, 24, 32, 128, 128, 1000),
                   (1, 16, 17, 9, 13, 4), (1, 9, 1, 5, 3, 8), (2, 12, 16, 128, 96, 132))


def check_roi_backward(c4, rois, seed, report, replaced):
    """The RoIAlign backward kernel against its plain version at a training
    step's shapes (g [1, 512, 14, 14, 1024] f32 onto a 38 x 50 map), on the
    adversarial boxes over a 38 x 50 and a 50 x 84 map, on the layouts of
    ``backward_stress_rois`` at the step's map and at the odd shapes of
    ``BACKWARD_SHAPES``; the plain version runs on the CPU for the check, as
    the forward's adversarial checks do (its einsums drift on the card), and
    on the card for its time. Within 1e-5 of max|ref|: fp32 sums, and
    atomics whose order changes from run to run (the largest difference
    between two launches on the same inputs is recorded). At the step and on
    each layout, ``replaced`` (the kernel this one replaced, from
    ``load_replaced_backward``) is held to the same tolerance and timed in
    turns with it. Then RoIAlign's autograd gradient (B3 forward, this
    backward) against autograd of the plain version on the card."""
    import numpy as np
    import torch

    from online_detection_tpu_torch.ops.roi_align import (
        roi_align, roi_align_backward, roi_align_backward_reference, roi_align_reference)

    def both_timed(g, boxes, h, w, ref, iters):
        """(new ms, replaced ms, replaced's max err): the replaced kernel held
        to 1e-5 of max|ref|, then the two timed in turns, new, replaced,
        replaced, new."""
        old = replaced(g, boxes, h, w).cpu()
        err = (old - ref).abs()
        if not err.max() <= 1e-5 * ref.abs().max():
            fail(f"the replaced RoIAlign backward kernel disagrees with the plain version "
                 f"(max err {float(err.max())})")
        t = {"new": [], "replaced": []}
        for k in ("new", "replaced", "replaced", "new"):
            fn = roi_align_backward if k == "new" else replaced
            t[k].append(timed(lambda: fn(g, boxes, h, w), iters))
        return sum(t["new"]) / 2, sum(t["replaced"]) / 2, float(err.max())

    rng = np.random.default_rng(seed + 11)
    rec = report.setdefault("roi_align_backward", {"calls": []})
    _, h, w, c = c4.shape
    g = torch.from_numpy(rng.normal(size=(1, rois.shape[1], 14, 14, c)).astype(np.float32)).cuda()
    got = roi_align_backward(g, rois, h, w)
    ref = roi_align_backward_reference(g.cpu(), rois.cpu(), h, w)
    check_close("roi_align_backward", got.cpu(), ref, 1e-5 * ref.abs().max(), report)
    spread = float((roi_align_backward(g, rois, h, w) - got).abs().max())
    card_plain = roi_align_backward_reference(g, rois, h, w)
    ms, old_ms, old_err = both_timed(g, rois, h, w, ref, 20)
    plain = timed(lambda: roi_align_backward_reference(g, rois, h, w), 3)
    flops = roi_ops(rois, h, w, c)
    nbytes = 4.0 * (g.numel() + got.numel() + rois.numel())
    bound, by = bound_of(flops, nbytes)
    cells = roi_footprint(rois.cpu(), h, w)
    add_call(rec, {"role": "training step", "shape": list(g.shape), "ms": ms, "plain_ms": plain,
                   "bound_ms": bound, "flops": flops, "bytes": nbytes,
                   "replaced_ms": old_ms, "replaced_max_abs_err": old_err,
                   "replaced_ms_recorded": REPLACED_BACKWARD_MS, "run_to_run_max_abs_diff": spread,
                   "footprint_cells_mean": float(cells.float().mean()),
                   "atomic_bytes": float(cells.sum()) * c * 4.0,
                   "card_plain_max_abs_err": float((card_plain - got).abs().max())})
    rec["replaced_ms"], rec["replaced_ms_recorded"] = old_ms, REPLACED_BACKWARD_MS
    print(f"  roi_align_backward[training step] {list(g.shape)} -> {list(got.shape)} f32: "
          f"{ms:.4f} ms (replaced kernel {old_ms:.4f} ms here, {REPLACED_BACKWARD_MS:.3f} ms "
          f"recorded; plain {plain:.3f} ms; "
          f"bound {bound:.4f} ms, {by}: {bound / ms:.0%} of it); max err "
          f"{float((got.cpu() - ref).abs().max()):.3g} of max|ref| {float(ref.abs().max()):.3g}; "
          f"two launches differ by {spread:.3g}; footprint {float(cells.float().mean()):.1f} "
          f"cells a RoI ({float(cells.sum()) * c * 4.0 / 1e6:.1f} MB of atomics beside "
          f"{4.0 * g.numel() / 1e6:.1f} MB of g)", flush=True)
    del card_plain

    worst = {}
    for hh, ww in ((38, 50), (50, 84)):
        adv = torch.from_numpy(adversarial_rois(rng, 2, 24, 16.0 * ww)).cuda()
        ga = torch.from_numpy(rng.normal(size=(2, 24, 14, 14, 1024)).astype(np.float32)).cuda()
        got_a = roi_align_backward(ga, adv, hh, ww).cpu()
        ref_a = roi_align_backward_reference(ga.cpu(), adv.cpu(), hh, ww)
        check_close("roi_align_backward", got_a, ref_a, 1e-5 * ref_a.abs().max(), report)
        worst[f"{hh}x{ww}"] = float((got_a - ref_a).abs().max())
    rec["adversarial_max_abs_err"] = worst

    stress = {}
    for role, boxes in backward_stress_rois(rng, rois.shape[1], h, w).items():
        boxes = torch.from_numpy(boxes).cuda()
        gs = g[:, :boxes.shape[1]].contiguous()
        got_s = roi_align_backward(gs, boxes, h, w)
        ref_s = roi_align_backward_reference(gs.cpu(), boxes.cpu(), h, w)
        check_close("roi_align_backward", got_s.cpu(), ref_s, 1e-5 * ref_s.abs().max(), report)
        cells = roi_footprint(boxes.cpu(), h, w)
        new_ms, old_ms, old_err = both_timed(gs, boxes, h, w, ref_s, 10)
        stress[role] = {
            "shape": list(gs.shape), "max_abs_err": float((got_s.cpu() - ref_s).abs().max()),
            "max_abs_ref": float(ref_s.abs().max()),
            "run_to_run_max_abs_diff": float((roi_align_backward(gs, boxes, h, w)
                                              - got_s).abs().max()),
            "footprint_cells_mean": float(cells.float().mean()),
            "atomic_bytes": float(cells.sum()) * c * 4.0, "ms": new_ms, "replaced_ms": old_ms,
            "replaced_max_abs_err": old_err}
        print(f"  roi_align_backward[{role}] {list(gs.shape)} onto {h}x{w}: {new_ms:.4f} ms "
              f"(replaced kernel {old_ms:.4f} ms); footprint {float(cells.float().mean()):.1f} "
              f"cells a RoI ({stress[role]['atomic_bytes'] / 1e6:.1f} MB of atomics); max err "
              f"{stress[role]['max_abs_err']:.3g} of max|ref| {stress[role]['max_abs_ref']:.3g}; "
              f"two launches differ by {stress[role]['run_to_run_max_abs_diff']:.3g}", flush=True)
    rec["stress"] = stress

    shapes = {}
    for b, r, p, hh, ww, cc in BACKWARD_SHAPES:
        adv = torch.from_numpy(adversarial_rois(rng, b, r, 16.0 * ww)).cuda()
        gx = torch.from_numpy(rng.normal(size=(b, r, p, p, cc)).astype(np.float32)).cuda()
        got_x = roi_align_backward(gx, adv, hh, ww, pooled=p).cpu()
        ref_x = roi_align_backward_reference(gx.cpu(), adv.cpu(), hh, ww, pooled=p)
        check_close("roi_align_backward", got_x, ref_x, 1e-5 * ref_x.abs().max(), report)
        shapes[f"{[b, r, p, p, cc]} onto {hh}x{ww}"] = float((got_x - ref_x).abs().max())
    rec["odd_shapes_max_abs_err"] = shapes
    print(f"  roi_align_backward at odd shapes (adversarial boxes): max err {shapes}", flush=True)

    f = c4.detach().clone().requires_grad_(True)
    f_ref = c4.detach().clone().requires_grad_(True)
    ct = g[0]
    (roi_align(f[0], rois[0]) * ct).sum().backward()
    (roi_align_reference(f_ref, rois)[0] * ct).sum().backward()
    check_close("roi_align_backward", f.grad, f_ref.grad, 1e-5 * f_ref.grad.abs().max(), report)
    rec["autograd_max_abs_err"] = float((f.grad - f_ref.grad).abs().max())
    rec["tolerance"] = "1e-5 max|ref| (fp32 sums; atomics in an order that changes run to run)"
    print(f"  roi_align_backward on adversarial boxes (C=1024, 2x24 boxes, 38x50 and 50x84 "
          f"maps): max err {worst}; RoIAlign autograd vs plain autograd on the card: "
          f"{rec['autograd_max_abs_err']:.3g}", flush=True)


def check_stem_grad(params, ds, report):
    """The stem's autograd gradient in (w, scale, bias): B2's fp32 route and
    ``stem_backward`` against autograd of the plain version on the card, on
    a training canvas [1, 608, 800, 3]. The gradient follows the recomputed
    pre-pool map: where a window's two largest positive values tie exactly
    (flat patches) both sides take the first, as the JAX package does; where
    they lie within rounding (a near tie) the kernel's forward may have
    taken the other. Both kinds of window are counted (ties at ReLU zeros
    carry no gradient). Within 1e-4 of each gradient's max|ref|: the weight
    gradient sums 121,600 window maxima of fp32 products."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from online_detection_tpu_torch.data.transforms import normalize_canvas
    from online_detection_tpu_torch.ops.stem_pool import stem_fused, stem_reference

    st = params.backbone.stem
    img = np.zeros(CANVAS + (3,), np.uint8)
    im = ds.load_image(0)
    img[:im.shape[0], :im.shape[1]] = im
    x = normalize_canvas(torch.from_numpy(img[None]).cuda())
    rng = np.random.default_rng(5)
    leaves = [t.detach().clone().requires_grad_(True) for t in (st.weight, st.scale, st.bias)]
    refs = [t.detach().clone().requires_grad_(True) for t in (st.weight, st.scale, st.bias)]
    out = stem_fused(x, *leaves)
    ct = torch.from_numpy(rng.normal(size=tuple(out.shape)).astype(np.float32)).cuda()
    (out * ct).sum().backward()
    (stem_reference(x, *refs) * ct).sum().backward()
    errs = {}
    for name, a, b in zip(("w", "scale", "bias"), leaves, refs):
        check_close("stem_pool grad", a.grad, b.grad, 1e-4 * b.grad.abs().max(), report)
        errs[name] = float((a.grad - b.grad).abs().max() / b.grad.abs().max())
    with torch.no_grad():  # the fp32 route's forward at the step's shape, timed
        args = (st.weight, st.scale, st.bias)
        ms = timed(lambda: stem_fused(x, *args), 20)
        flops = 2.0 * out.shape[1] * 2 * out.shape[2] * 2 * 64 * 147  # the conv before the pool
        bound, by = bound_of(flops, 4.0 * (x.numel() + out.numel() + st.weight.numel() + 128))
    report["stem_pool"]["f32_route_train"] = {"shape": list(x.shape), "ms": ms, "bound_ms": bound,
                                              "bound_by": by}
    print(f"  stem_pool fp32 route at the training canvas {list(x.shape)}: {ms:.4f} ms (bound "
          f"{bound:.4f} ms, {by}: {bound / ms:.1%} of it)", flush=True)
    with torch.no_grad():  # windows whose two largest positive values tie or nearly do
        z = F.conv2d(x.permute(0, 3, 1, 2), st.weight, stride=2, padding=3)
        r = torch.relu(z * st.scale[:, None, None] + st.bias[:, None, None])
        win = F.unfold(F.pad(r, (1, 1, 1, 1), value=-1.0).reshape(-1, 1, *[d + 2 for d in
                       r.shape[2:]]), 3, stride=2)  # [64, 9, windows]
        top2 = win.topk(2, dim=1).values
        gap = top2[:, 0] - top2[:, 1]
        positive = top2[:, 0] > 0
        exact = int((positive & (gap == 0)).sum())  # flat patches: the same sums
        near = int((positive & (gap > 0) & (gap <= 1e-6 * top2[:, 0])).sum())
    stats = {"relative_max_err": errs, "exact_tie_windows": exact, "near_tie_windows": near,
             "windows": int(top2[:, 0].numel()),
             "tolerance": "1e-4 max|ref| (fp32 sums; a near tie may move one window's gradient)"}
    report["stem_pool"]["grad"] = stats
    print(f"  stem_pool gradient (kernel forward + stem_backward vs plain autograd) on "
          f"{list(x.shape)}: relative max err {errs}; windows with an exact tie {exact}, "
          f"a near tie (within 1e-6) {near}, of {stats['windows']}", flush=True)


def small_sgd_reference_check(params, report, dev):
    """One ``training_loss`` gradient on a 128x192 canvas at full channel
    width on the card (B2, B3 and the backward kernel, IEEE fp32) and on the
    CPU (plain versions), with the same params and the same draws
    (``roi_batch`` 32, ``post_nms_train`` 30): the loss within 1e-4 relative,
    every leaf's gradient within 2e-3 of its max|ref| (the CPU tests hold the
    port to the JAX package at the same tolerance)."""
    import numpy as np
    import torch

    from online_detection_tpu_torch.engine.trainer import (
        SGDConfig, host_batch, named_leaves, trainable_copy, training_loss)
    from online_detection_tpu_torch.models.anchors import grid_anchors
    from online_detection_tpu_torch.utils.device import ieee_fp32

    h, w = 128, 192
    ds = SyntheticTeachingSet(1, (h, w), N_CLASSES, 9, min_side=32, max_side=96)
    cfg = SGDConfig(post_nms_train=30, roi_batch=32)
    anchors = grid_anchors(h // 16, w // 16)
    host = host_batch(ds, 0, (h, w), h, 320, 20, anchors, True, 0.0, None, False)
    rng = np.random.default_rng(17)
    draws = [rng.random(anchors.shape[0]), rng.random(anchors.shape[0]), rng.random(50),
             rng.random(50)]

    def grads(device):
        p, _ = trainable_copy(params, torch.device(device), cfg)
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        u = [torch.from_numpy(d.astype(np.float32)).to(device) for d in draws]
        with ieee_fp32():
            loss = training_loss(p, batch, torch.from_numpy(anchors).to(device), cfg, True, u)
            loss.backward()
        return float(loss.detach()), {k: t.grad.cpu() for k, t in named_leaves(p)}

    lg, gg = grads(dev)
    lc, gc = grads("cpu")
    worst = max(float((gg[k] - gc[k]).abs().max() / gc[k].abs().max().clamp(min=1e-30))
                for k in gc)
    err = {"loss": [lg, lc], "leaves": len(gc), "worst_relative_leaf_err": worst}
    report["sgd"]["small_reference"] = err
    print(f"  training_loss gradient, card vs CPU plain path on {h}x{w}: {err}", flush=True)
    if abs(lg - lc) > 1e-4 * abs(lc) or worst > 2e-3:
        fail(f"training_loss gradient: card and CPU disagree: {err}")


def sgd_phase(seed, card, report, out_dir, dev, replaced_backward):
    """The SGD baselines at full width: ``do_train`` for SGD_STEPS steps over
    SGD_IMAGES 800x600 teaching images (608x800 canvases) with the solver of
    ``config_full_train_ycbv.yaml``, nothing frozen (B2, B3 and the RoIAlign
    backward +1 a step; one step traced); the kernels' gradients against
    their plain versions, the backward beside the kernel it replaced
    (``replaced_backward``, from ``load_replaced_backward``); then
    ``dump_backbone_features`` of the images (B2 +1 an image) and FT_STEPS
    fine-tuning steps from the cached maps with the backbone and the RPN's
    conv frozen (bit-identical afterwards, no RoIAlign backward); the card
    against the CPU on a small canvas; then the two SGD CLIs and the tester
    over the fine-tuned ``model_final.pkl``."""
    import math
    import pickle

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from online_detection_tpu_torch.data.datasets.synthetic import make_synthetic_icwt
    from online_detection_tpu_torch.engine.backbone_cache import (
        FromFeatDataset, dump_backbone_features)
    from online_detection_tpu_torch.engine.trainer import SGDConfig, do_train, freeze_mask
    from online_detection_tpu_torch.experiments import run_experiment_fine_tuning as ft_cli
    from online_detection_tpu_torch.experiments import run_experiment_full_train as full_cli
    from online_detection_tpu_torch.experiments import run_experiment_test_feature_task as tester
    from online_detection_tpu_torch.experiments._common import load_configs
    from online_detection_tpu_torch.ops import _build
    from online_detection_tpu_torch.utils.device import ieee_fp32

    rec = report.setdefault("sgd", {"card": card})
    work = ROOT / ".bench" / "sgd"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    paths = {}
    try:
        _, _, extras = load_configs("config_full_train_ycbv.yaml", None)
        cfg = SGDConfig(**extras["sgd"])._replace(max_iter=SGD_STEPS)
        params = sgd_params(seed + 7)
        caller = leaves_of(params)
        ds = teaching_set(SGD_IMAGES, seed + 8)

        marks, snaps, trace = [], [], {}

        def each_step(_, it):  # after step it >= 1: the counters, and the time
            torch.cuda.synchronize()
            end = time.time()
            snaps.append(dict(_build.LAUNCHES))
            if it == SGD_TRACED_STEP - 1:
                trace["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                trace["prof"].__enter__()
                trace["t0"] = time.time()
            elif it == SGD_TRACED_STEP:
                trace["prof"].__exit__(None, None, None)
                trace["wall_us"] = (end - trace["t0"]) * 1e6
            # (step it's end, the next step's start): this callback's own work is no step's
            marks.append((end, time.time()))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.time()
        trained, hist = do_train(params, ds, CANVAS, cfg, torch.Generator().manual_seed(seed),
                                 with_mask=True, min_size=TRAIN_HW[0], log_every=4,
                                 val_fn=each_step, val_period=1, device=dev)
        torch.cuda.synchronize()
        train_s = time.time() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        paths["sgd full train"] = launches = dict(_build.LAUNCHES)
        want = {k: 0 for k in COUNTERS}
        want.update(stem_pool=SGD_STEPS, roi_align=SGD_STEPS, roi_align_backward=SGD_STEPS)
        if launches != want:
            fail(f"full training launched {launches}, expected {want}")
        for it, snap in enumerate(snaps, start=1):  # +1 of each a step
            if any(snap[k] != it + 1 for k in ("stem_pool", "roi_align", "roi_align_backward")):
                fail(f"after step {it} the counters read {snap}: B2, B3 and the backward must "
                     f"rise by one a step")
        if len(hist) != SGD_STEPS or not all(math.isfinite(v) for v in hist):
            fail(f"full training losses {hist}")
        after = leaves_of(trained)
        still = [k for k in caller if torch.equal(after[k], caller[k])]
        if still:
            fail(f"full training left {len(still)} trainable leaves unmoved: {still[:5]}")
        if any(not torch.equal(t, caller[k]) for k, t in leaves_of(params).items()):
            fail("do_train changed the caller's params")
        step_ms = [(b[0] - a[1]) * 1e3 for a, b in zip(marks, marks[1:])]  # steps 2, 3, ...
        steady = [t for i, t in enumerate(step_ms, start=2) if i != SGD_TRACED_STEP]
        profiled = profile_summary(trace["prof"], trace["wall_us"], out_dir / "sgd_profile.txt",
                                   card)
        rec.update(config={k: v for k, v in cfg._asdict().items()}, losses=hist,
                   step_ms=step_ms, median_step_ms=float(np.median(steady)),
                   train_s=train_s, peak_gib=peak_gib, launches=launches, profile=profiled)
        print(f"do_train (full training, nothing frozen) {SGD_STEPS} steps over {SGD_IMAGES} "
              f"images at {CANVAS[1]}x{CANVAS[0]}, roi_batch {cfg.roi_batch}, post_nms_train "
              f"{cfg.post_nms_train}, base_lr {cfg.base_lr}, wd {cfg.weight_decay}, warmup "
              f"{cfg.warmup_iters}: {train_s:.2f} s; ms a step (steps 2-{SGD_STEPS - 1}) "
              f"{[round(t, 2) for t in step_ms]}, median {rec['median_step_ms']:.2f} (traced "
              f"step {SGD_TRACED_STEP} left out); losses {[round(v, 4) for v in hist]}; peak "
              f"{peak_gib:.2f} GiB; launches {launches} on {card}", flush=True)
        print(f"profile of training step {SGD_TRACED_STEP}: {json.dumps(profiled)}", flush=True)

        with ieee_fp32():
            c4, rois = step_inputs(trained, ds, cfg, dev, torch.Generator().manual_seed(1))
            check_roi_backward(c4.detach(), rois.detach(), seed, report, replaced_backward)
            del c4
            check_stem_grad(trained, ds, report)
        del trained
        torch.cuda.empty_cache()

        # fine-tuning from the cached backbone maps
        on_card = sgd_params(seed + 7).to(dev)
        _build.reset_launches()
        t0 = time.time()
        feat_dir = dump_backbone_features(on_card, ds, str(work), CANVAS, TRAIN_HW[0], 1333,
                                          device=dev)
        dump_s = time.time() - t0
        paths["sgd backbone dump"] = launches = dict(_build.LAUNCHES)
        want = {k: 0 for k in COUNTERS}
        want.update(stem_pool=SGD_IMAGES)
        if launches != want:
            fail(f"dump_backbone_features launched {launches}, expected {want}")
        ft_cfg = cfg._replace(max_iter=FT_STEPS, freeze_backbone=True,
                              freeze_rpn_except_logits=True)
        _build.reset_launches()
        t0 = time.time()
        tuned, ft_hist = do_train(on_card, FromFeatDataset(ds, feat_dir), CANVAS, ft_cfg,
                                  torch.Generator().manual_seed(seed), with_mask=True,
                                  min_size=TRAIN_HW[0], log_every=4, device=dev)
        torch.cuda.synchronize()
        ft_s = time.time() - t0
        paths["sgd fine-tune"] = launches = dict(_build.LAUNCHES)
        want = {k: 0 for k in COUNTERS}
        want.update(roi_align=FT_STEPS)
        if launches != want:
            fail(f"fine-tuning from features launched {launches}, expected {want}")
        mask = freeze_mask(tuned, ft_cfg)
        after = leaves_of(tuned)
        moved_frozen = [k for k, m in mask.items() if not m and not torch.equal(after[k], caller[k])]
        still = [k for k, m in mask.items() if m and torch.equal(after[k], caller[k])]
        if moved_frozen or still or not all(math.isfinite(v) for v in ft_hist):
            fail(f"fine-tuning: frozen leaves moved {moved_frozen[:5]}, trainable leaves "
                 f"unmoved {still[:5]}, losses {ft_hist}")
        n_frozen = sum(1 for m in mask.values() if not m)
        rec.update(dump_s=dump_s, fine_tune_s=ft_s, fine_tune_losses=ft_hist,
                   frozen_leaves=n_frozen, fine_tune_launches=launches)
        print(f"dump_backbone_features of {SGD_IMAGES} images: {dump_s:.2f} s; fine-tuning "
              f"{FT_STEPS} steps from the cached maps ({n_frozen} frozen leaves bit-identical "
              f"afterwards): {ft_s:.2f} s, losses {[round(v, 4) for v in ft_hist]}, launches "
              f"{launches} on {card}", flush=True)
        del on_card, tuned
        torch.cuda.empty_cache()

        small_sgd_reference_check(params, report, dev)

        # the CLIs on a PIL-written tree
        root = work / "ycbv_synth"
        make_synthetic_icwt(str(root), n_train=8, n_test=4, image_hw=(240, 320))
        (work / "feat.yaml").write_text(CLI_SGD_CFG.format(root=root))
        clis = {}
        for name, main, flags, steps, rise in (
                ("full_train", full_cli.main, [], 3,
                 {"stem_pool": 3, "roi_align": 3, "roi_align_backward": 3}),
                ("fine_tuning", ft_cli.main, ["--use_backbone_features"], 2,
                 {"stem_pool": 8, "roi_align": 2})):
            out = work / name
            _build.reset_launches()
            t0 = time.time()
            main(["--output_dir", str(out), "--config_file", str(work / "feat.yaml"),
                  "--max_iter", str(steps)] + flags)
            run_s = time.time() - t0
            paths[f"cli {name}"] = launches = dict(_build.LAUNCHES)
            want = {k: 0 for k in COUNTERS}
            want.update(rise)
            h = np.load(out / "loss_history.npy")
            with open(out / "model_final.pkl", "rb") as f:
                tree = pickle.load(f)
            if launches != want or len(h) != steps or not np.isfinite(h).all() or \
                    tree["box_predictor"]["cls_w"].shape != (2048, 20):
                fail(f"{name} CLI: launches {launches} (expected {want}), losses {h}")
            clis[name] = {"seconds": run_s, "losses": h.tolist(), "launches": launches}
            print(f"  {name} CLI --max_iter {steps} {' '.join(flags)}: {run_s:.2f} s, losses "
                  f"{h.tolist()}, launches {launches} on {card}", flush=True)
        _build.reset_launches()
        t0 = time.time()
        results = tester.main(["--output_dir", str(work / "tester"), "--models_dir",
                               str(work / "fine_tuning"), "--config_file", str(work / "feat.yaml")])
        tester_s = time.time() - t0
        paths["cli tester"] = launches = dict(_build.LAUNCHES)
        maps = {Path(k).name: {m: r[m] for m in ("det_map_0.5", "segm_map_0.5")}
                for k, r in results.items()}
        if list(maps) != ["model_final.pkl"] or not all(
                math.isfinite(v) for r in maps.values() for v in r.values()):
            fail(f"tester CLI over the fine-tuned checkpoint: {maps}")
        if launches["stem_pool"] != 4 or launches["roi_align"] != 8:
            fail(f"tester CLI over 4 images launched {launches}")
        clis["tester"] = {"seconds": tester_s, "maps": maps, "launches": launches}
        print(f"  tester CLI over the fine-tuned model_final.pkl: {tester_s:.2f} s, mAPs {maps}, "
              f"launches {launches} on {card}", flush=True)
        rec["clis"] = clis
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec["launches"] = paths
    return paths


# ---------------------------------------------------------------------------
# the module facades, the demo and the incremental teacher, the f32 trunk


def timed_call(fn):
    """(result, seconds) of one call, synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def launches_of(fn):
    """(result, seconds, launches) of one call, the counters read right after it."""
    from online_detection_tpu_torch.ops import _build

    _build.reset_launches()
    out, seconds = timed_call(fn)
    return out, seconds, dict(_build.LAUNCHES)


def check_launches(where, got, rising, exact=None):
    """Every kernel of ``rising`` launched, no other one did; ``exact``
    holds the counts that must be met exactly."""
    idle = sorted(k for k in rising if got[k] == 0)
    stray = sorted(k for k in COUNTERS if k not in rising and got[k])
    wrong = {k: (got[k], n) for k, n in (exact or {}).items() if got[k] != n}
    if idle or stray or wrong:
        fail(f"{where} launched {got}: idle {idle}, not on its path {stray}, "
             f"(got, expected) {wrong}")


def facade_test_boxes(params, online_rpn, test_set, dcfg, dev, gt_cap=20):
    """The cached test_boxes of the standalone experiments for the held-out
    images: GT ++ the on-line RPN's proposals and their res5 features from
    the harvest trunk (B2, B4), a batch of 8 at a time, GT rows flagged; and
    the evaluator's ground truths."""
    import numpy as np
    import torch

    from online_detection_tpu_torch.data.transforms import preprocess_image_u8
    from online_detection_tpu_torch.engine.harvest import harvest_trunk
    from online_detection_tpu_torch.models.anchors import grid_anchors

    h, w = CANVAS
    anchors = torch.from_numpy(grid_anchors(h // 16, w // 16)).to(dev)
    test_boxes, gts = [], []
    for lo in range(0, len(test_set), BATCH_SIZE):
        idx = range(lo, min(lo + BATCH_SIZE, len(test_set)))
        # 800x600 needs no resize (scale 1): padded onto the canvas only
        loaded = [preprocess_image_u8(test_set.load_image(i), CANVAS, 600, 1333) for i in idx]
        images = torch.from_numpy(np.stack([c for c, _, _ in loaded])).to(dev)
        sizes = torch.tensor([swh for _, _, swh in loaded], dtype=torch.float32, device=dev)
        gt = torch.zeros((len(idx), gt_cap, 4), device=dev)
        gt_valid = torch.zeros((len(idx), gt_cap), dtype=torch.bool, device=dev)
        for k, i in enumerate(idx):
            boxes = test_set.get_annotation(i).boxes
            gt[k, :len(boxes)] = torch.from_numpy(boxes).to(dev)
            gt_valid[k, :len(boxes)] = True
        _, props, pvalid, feats, _ = harvest_trunk(params, online_rpn, anchors, images, sizes,
                                                   gt, gt_valid, dcfg, with_mask_features=False)
        rows = torch.cat([gt, props], 1)
        valid = torch.cat([gt_valid, pvalid], 1)
        is_gt = torch.cat([gt_valid, torch.zeros_like(pvalid)], 1)
        for k, i in enumerate(idx):
            v = valid[k]
            test_boxes.append({"boxes": rows[k][v].cpu().numpy(), "feat": feats[k][v],
                               "gt": is_gt[k][v].cpu().numpy(), "img_size": loaded[k][2]})
            anno = test_set.get_annotation(i)
            gts.append({"boxes": anno.boxes, "labels": anno.labels,
                        "difficult": anno.difficult})
    return test_boxes, gts


def facades_phase(params, det, host_online, seed, card, report):
    """The module facades at full width (d 2048, M 1000, 21 classes) on the
    host route's detector pools (its COXY rows as each class's positives,
    its negative batches as the reference's list-of-batches layout) and
    feature statistics: ``OnlineRegionClassifier.trainRegionClassifier``
    held against ``train_classifiers_minibootstrap`` on the same buffers and
    draws; ``FALKONWrapper.train`` on class 1's cache and ``predict`` held
    against ``mmv_reference``; ``RegionRefiner`` on the COXY rows, held
    against the host route's detector refiners (the same ridge on the same
    rows); then the standalone experiment on the held-out images (test
    boxes from the harvest trunk with the host route's on-line RPN: the
    random trunk's own RPN proposes nothing near the objects;
    ``testRegionClassifier``, ``RegionRefiner.predict``,
    ``AccuracyEvaluatorStandalone``)."""
    import numpy as np
    import torch

    from online_detection_tpu_torch.models.detector import DetectorConfig
    from online_detection_tpu_torch.modules.facades import (
        AccuracyEvaluatorStandalone, FALKONWrapper, OnlineRegionClassifier, RegionRefiner)
    from online_detection_tpu_torch.ops.gaussian_mmv import mmv_reference
    from online_detection_tpu_torch.pipelines.online_pipeline import OnlineTrainConfig
    from online_detection_tpu_torch.solvers.falkon import falkon_predict_classes
    from online_detection_tpu_torch.solvers.minibootstrap import (
        MinibootstrapParams, train_classifiers_minibootstrap)
    from online_detection_tpu_torch.solvers.rls import rls_predict
    from online_detection_tpu_torch.utils.device import ieee_fp32

    cfg, dev = OnlineTrainConfig(), torch.device("cuda")
    coxy = det["coxy"]
    c_lab = np.asarray(coxy["C"]).reshape(-1).astype(int)
    positives = [coxy["X"][c_lab == c + 1] for c in range(N_CLASSES)]
    negatives = [[det["neg"][c, i][det["neg_valid"][c, i]] for i in range(det["neg"].shape[1])]
                 for c in range(N_CLASSES)]
    wrapper = FALKONWrapper()
    wrapper.sigma, wrapper.lam, wrapper.nyst_centers = cfg.det_sigma, cfg.det_lam, cfg.det_m
    oc = OnlineRegionClassifier(wrapper, positives, negatives, host_online.detector.stats)
    rec, paths = {"card": card}, {}

    models, train_s, paths["facade minibootstrap"] = launches_of(oc.trainRegionClassifier)
    check_launches("trainRegionClassifier", paths["facade minibootstrap"],
                   {"gaussian_mmv", "tf32_split"}, {"gaussian_mmv": cfg.iterations})
    with torch.inference_mode(), ieee_fp32():
        pos, pv, neg, nv = (torch.from_numpy(a).to(dev) for a in oc._to_buffers())
        ref = train_classifiers_minibootstrap(
            oc.zScores(pos) * pv[..., None], pv, oc.zScores(neg) * nv[..., None], nv,
            MinibootstrapParams(m=cfg.det_m, sigma=cfg.det_sigma, lam=cfg.det_lam,
                                hard_thresh=oc.hard_tresh, easy_thresh=oc.easy_tresh),
            generator=torch.Generator().manual_seed(0))
        del pos, pv, neg, nv
        probe = oc.zScores(np.concatenate([p[:64] for p in positives]
                                          + [negatives[0][0][:256]]))
        got = falkon_predict_classes(models, probe)
        want = falkon_predict_classes(ref, probe)
    if not torch.equal(models.exists, ref.exists) or not bool(models.exists.all()):
        fail(f"trainRegionClassifier: exists {models.exists.tolist()} against the solver's "
             f"{ref.exists.tolist()}")
    check_close("facade scores", got, want, 1e-5 * want.abs().max(), report)
    rec["classifier"] = {"train_s": train_s, "launches": paths["facade minibootstrap"],
                         "max_abs_err_vs_solver": report["facade scores"]["max_abs_err"]}
    print(f"  OnlineRegionClassifier.trainRegionClassifier, {N_CLASSES} classes, "
          f"{det['neg'].shape[1]} x {det['neg'].shape[2]} negatives a class, d 2048, M "
          f"{cfg.det_m}: {train_s:.3f} s; scores against train_classifiers_minibootstrap on the "
          f"same buffers: max err {report['facade scores']['max_abs_err']:.2e}; launches "
          f"{paths['facade minibootstrap']} on {card}", flush=True)

    # FALKONWrapper on class 1's cache: its positives and negatives, z-scored
    with torch.inference_mode():
        x = oc.zScores(np.concatenate([positives[0]] + negatives[0]))
    y = torch.cat([torch.ones(len(positives[0])), -torch.ones(len(x) - len(positives[0]))])
    fmodel, fit_s, paths["facade falkon train"] = launches_of(lambda: wrapper.train(x, y))
    check_launches("FALKONWrapper.train", paths["facade falkon train"], set())
    scores, predict_s, paths["facade falkon predict"] = launches_of(
        lambda: wrapper.predict(fmodel, x))
    check_launches("FALKONWrapper.predict", paths["facade falkon predict"],
                   {"gaussian_mmv", "tf32_split"}, {"gaussian_mmv": 1})
    with torch.inference_mode(), ieee_fp32():
        c, a = fmodel.centers[None], fmodel.alpha[None]
        ref = mmv_reference(x, c, a, fmodel.sigma)[0]
        terms = mmv_reference(x, c, a.abs(), fmodel.sigma)[0]
    check_close("gaussian_mmv", scores, ref, 1e-5 * terms + 1e-30, report)
    acc = float(((scores > 0) == (y.to(dev) > 0)).float().mean())
    rec["falkon_wrapper"] = {"rows": len(x), "train_s": fit_s, "predict_ms": predict_s * 1e3,
                             "train_accuracy": acc,
                             "max_abs_err_vs_plain": float((scores - ref).abs().max())}
    print(f"  FALKONWrapper on class 1's cache ({len(x)} rows, M {cfg.det_m}): train "
          f"{fit_s:.3f} s, predict {predict_s * 1e3:.2f} ms (one B1 launch, against "
          f"mmv_reference: max err {rec['falkon_wrapper']['max_abs_err_vs_plain']:.2e}); "
          f"training accuracy {acc:.4f} on {card}", flush=True)
    if acc < 0.9:
        fail(f"FALKONWrapper separates its own training rows at {acc:.4f}")

    # RegionRefiner: the detector's ridge on the COXY rows
    refiner = RegionRefiner()
    refiner.lam, refiner.num_classes = cfg.det_reg_lam, N_CLASSES
    regs, reg_s = timed_call(lambda: refiner.trainRegionRefiner(coxy))
    with torch.inference_mode():
        xr = torch.from_numpy(coxy["X"][:512]).to(dev)
        got, want = rls_predict(regs, xr), rls_predict(host_online.detector.rls, xr)
    if not torch.equal(regs.exists, host_online.detector.rls.exists):
        fail("RegionRefiner: its classes differ from the host route's refiners'")
    check_close("facade refiner", got, want, 1e-4 * want.abs().max() + 1e-6, report)
    rec["refiner"] = {"train_s": reg_s, "max_abs_err_vs_host_route":
                      report["facade refiner"]["max_abs_err"]}

    # the standalone experiment on the held-out images
    test_set = teaching_set(HELD_OUT_IMAGES, seed + 1)
    with torch.inference_mode(), ieee_fp32():
        (test_boxes, gts), boxes_s, paths["facade test boxes"] = launches_of(
            lambda: facade_test_boxes(params, host_online.rpn, test_set, DetectorConfig(), dev))
    n_b = -(-HELD_OUT_IMAGES // BATCH_SIZE)
    check_launches("the test boxes' harvest trunk", paths["facade test boxes"],
                   {"gaussian_mmv", "tf32_split", "stem_pool", "roi_align_fused2"},
                   {"gaussian_mmv": n_b, "stem_pool": n_b, "roi_align_fused2": n_b})
    preds, test_s, paths["facade test"] = launches_of(
        lambda: oc.testRegionClassifier(models, test_boxes))
    check_launches("testRegionClassifier", paths["facade test"], {"gaussian_mmv", "tf32_split"},
                   {"gaussian_mmv": HELD_OUT_IMAGES})
    t0 = time.time()
    for p, tb in zip(preds, test_boxes):
        keep = ~tb["gt"].astype(bool)
        refined = refiner.predict(p["boxes"], tb["feat"][torch.from_numpy(keep).cuda()],
                                  p["img_size"])
        p["boxes"] = np.concatenate([p["boxes"], refined], axis=1)
    refine_s = time.time() - t0
    evaluator = AccuracyEvaluatorStandalone()
    results, eval_s = timed_call(
        lambda: evaluator.evaluate(gts, preds, class_names=list(test_set.classes)))
    v = results["det_map_0.5"]
    if not (np.isfinite(v) and 0.0 < v <= 1.0):
        fail(f"AccuracyEvaluatorStandalone: det mAP@0.5 {v}")
    rec["standalone"] = {"images": HELD_OUT_IMAGES, "test_boxes_s": boxes_s,
                         "test_region_classifier_s": test_s, "refine_s": refine_s,
                         "evaluate_s": eval_s, "det_map_0.5": v,
                         "rows": int(sum(len(p["scores"]) for p in preds))}
    print(f"  RegionRefiner on {len(coxy['X'])} COXY rows: {reg_s:.3f} s, against the host "
          f"route's refiners: max err {rec['refiner']['max_abs_err_vs_host_route']:.2e}; "
          f"standalone experiment on {HELD_OUT_IMAGES} held-out images: test boxes "
          f"{boxes_s:.3f} s, testRegionClassifier {test_s:.3f} s, RegionRefiner.predict "
          f"{refine_s:.3f} s, AccuracyEvaluatorStandalone.evaluate {eval_s:.3f} s, det "
          f"mAP@0.5 {v:.4f} on {card}", flush=True)
    rec["launches"] = paths
    report["facades"] = rec
    return paths


def demo_phase(params, trained, seed, card, report):
    """``OnlineSegmentationDemo.run_on_image`` with the device route's models
    on 8 held-out images, one at a time: boxes, scores and labels equal to
    ``detect_batched``'s on the same canvas, B1/B2/B3 launched as a batch of
    one, ``overlay`` on each. Then an ``IncrementalTeacher`` at full width
    taught two classes, then a third with ``add_new_class``, four
    observations of each with masks, ``update_model`` after each round:
    every taught class exists, and each observation is harvested once (B2
    and B4 +1) an update."""
    import numpy as np
    import torch

    from online_detection_tpu_torch.data.transforms import preprocess_image_u8
    from online_detection_tpu_torch.models.anchors import grid_anchors
    from online_detection_tpu_torch.models.detector import DetectorConfig, detect_batched
    from online_detection_tpu_torch.modules.demo import IncrementalTeacher, OnlineSegmentationDemo

    dcfg = DetectorConfig()
    test_set = teaching_set(BATCH_SIZE, seed + 1)
    demo = OnlineSegmentationDemo(params, trained, test_set.classes, CANVAS, dcfg)
    h, w = CANVAS
    anchors = torch.from_numpy(grid_anchors(h // 16, w // 16)).cuda()
    paths, ms, detect_ms, kept = {}, [], [], []
    per_image = dict(EXPECTED_LAUNCHES)
    for i in range(len(test_set)):
        rgb = test_set.load_image(i)
        result, sec, launches = launches_of(lambda: demo.run_on_image(rgb))
        check_launches("run_on_image", launches, {k for k, n in per_image.items() if n},
                       per_image)
        for k, n in launches.items():
            paths.setdefault("demo run_on_image", dict.fromkeys(COUNTERS, 0))[k] += n
        ms.append(sec * 1e3)
        canvas, scale, (sw, sh) = preprocess_image_u8(rgb, CANVAS, 600, 1333)
        (dets, _, _, _), detect_s = timed_call(
            lambda: detect_batched(params, trained, anchors, canvas[None], [[sw, sh]], dcfg,
                                   True))
        detect_ms.append(detect_s * 1e3)
        keep = (dets.valid[0] & (dets.scores[0] >= demo.confidence_threshold)).cpu().numpy()
        for name, want in (("boxes", dets.boxes[0].cpu().numpy()[keep] / scale),
                           ("scores", dets.scores[0].cpu().numpy()[keep]),
                           ("labels", dets.labels[0].cpu().numpy()[keep])):
            if not np.array_equal(result[name], want):
                fail(f"run_on_image {i}: its {name} differ from detect_batched's")
        if result["masks"].shape != (len(result["boxes"]),) + rgb.shape[:2]:
            fail(f"run_on_image {i}: masks {result['masks'].shape}")
        overlay = demo.overlay(rgb, result)
        if overlay.shape != rgb.shape or overlay.dtype != np.uint8:
            fail(f"overlay {i}: {overlay.shape} {overlay.dtype}")
        kept.append(len(result["boxes"]))
    rec = {"card": card, "run_on_image_ms": ms, "detect_batched_ms": detect_ms, "kept": kept}
    print(f"  OnlineSegmentationDemo.run_on_image on {len(test_set)} held-out images of "
          f"{TRAIN_HW[1]}x{TRAIN_HW[0]}: ms an image {[round(t, 2) for t in ms]} (median "
          f"{float(np.median(ms)):.2f}; detect_batched alone on the same canvas, median "
          f"{float(np.median(detect_ms)):.2f}), detections kept {kept}, equal to "
          f"detect_batched's; launches {paths['demo run_on_image']} on {card}", flush=True)

    # the teacher: 4 observations of each of 3 classes, the third added later
    ts = SyntheticTeachingSet(12, TRAIN_HW, 3, seed + 2, *OBJECT_SIDES)
    teacher = IncrementalTeacher(params, canvas_hw=CANVAS)
    rounds = []
    for names in (["object_1", "object_2"], ["object_3"]):
        for name in names:
            label = teacher.add_new_class(name)
            for i in range(label - 1, len(ts), 3):  # image i shows class i % 3 + 1
                anno = ts.get_annotation(i)
                teacher.observe(ts.load_image(i), anno.boxes[0], label, ts.load_masks(i)[0])
        n_obs = len(teacher._observations)
        online, sec, launches = launches_of(teacher.update_model)
        check_launches("update_model", launches,
                       {"gaussian_mmv", "tf32_split", "stem_pool", "roi_align_fused2"},
                       {"stem_pool": n_obs, "roi_align_fused2": n_obs})
        paths[f"teacher update {len(rounds) + 1}"] = launches
        exists = {h: getattr(online, h).falkon.exists.tolist() for h in ("detector", "mask")}
        if any(len(e) != teacher.num_classes or not all(e) for e in exists.values()):
            fail(f"update_model with {teacher.num_classes} classes: exists {exists}")
        rounds.append({"classes": teacher.num_classes, "observations": n_obs, "seconds": sec,
                       "launches": launches, "rpn_classes": int(online.rpn.falkon.exists.sum())})
        print(f"  IncrementalTeacher.update_model, {teacher.num_classes} classes, {n_obs} "
              f"observations with masks: {sec:.3f} s; detector and mask exist for every class; "
              f"launches {launches} on {card}", flush=True)
    rec["teacher"] = rounds
    rec["launches"] = paths
    report["demo"] = rec
    return paths


def mfu_lines(times, detect_profile, card, report):
    """Model FLOPs utilisation of a ``detect_batched`` batch and of a device
    harvest batch at the bf16 peak, from ``utils/flops.py`` and this run's
    times: the host clock around a synchronised batch, and the device's
    busy time in the traced batch."""
    import numpy as np

    from online_detection_tpu_torch.models.detector import DetectorConfig
    from online_detection_tpu_torch.utils import flops

    dcfg = DetectorConfig()
    h, w = CANVAS
    per_batch = {
        "detect_batched": BATCH_SIZE * flops.inference_image_flops(
            h, w, dcfg.post_nms_top_n, dcfg.detections_per_img, N_CLASSES, N_ANCHORS),
        "harvest": BATCH_SIZE * flops.harvest_image_flops(h, w, dcfg.post_nms_top_n, 20,
                                                          N_ANCHORS)}
    n_batches = -(-TRAIN_IMAGES // BATCH_SIZE)
    wall_ms = {"detect_batched": float(np.median(times)),
               "harvest": report["training"]["harvest_s"] / n_batches * 1e3}
    busy_ms = {"detect_batched": detect_profile["busy_ms"],
               "harvest": report["training"]["harvest_profile"]["busy_ms"]}
    rec = {"card": card, "peak_tflops": flops.H100_PEAK_BF16_TFLOPS}
    for k, f in per_batch.items():
        rec[k] = {"gflop_per_batch": f / 1e9, "wall_ms": wall_ms[k], "busy_ms": busy_ms[k],
                  "mfu_wall": flops.mfu(f / (wall_ms[k] / 1e3)),
                  "mfu_busy": flops.mfu(f / (busy_ms[k] / 1e3))}
        print(f"MFU of a {k} batch of {BATCH_SIZE} at {w}x{h}: {f / 1e12:.3f} TFLOP, "
              f"{wall_ms[k]:.2f} ms wall -> {rec[k]['mfu_wall']:.2%}; {busy_ms[k]:.2f} ms "
              f"device busy (traced batch) -> {rec[k]['mfu_busy']:.2%} of "
              f"{flops.H100_PEAK_BF16_TFLOPS:.0f} TFLOP/s bf16 on {card}", flush=True)
    report["mfu"] = rec


def f32_trunk_phase(params, trained, seed, card, report):
    """The device route's training and ``run_inference`` once more with
    ``ODTPU_COMPUTE_DTYPE=float32`` (the trunk in f32: B2's fp32 route), on
    the same seed and images, the variable restored after; its launch counts
    equal the bf16 run's, its models are finite and exist for the classes
    the bf16 run's do, and its mAPs (and those of the f32 trunk with the
    bf16 run's models) are finite and printed, not held: on random trunk
    weights with 3 teaching images a class they depend on the training draw
    (one class's FALKON model can score over 3 on every proposal and take
    every slot: det mAP 0 at 4 of 6 training draws, PERF.md). Then one held-out batch of
    8 through ``detect_batched`` with each trunk and its own models, timed."""
    import os

    import numpy as np
    import torch

    from online_detection_tpu_torch.models.anchors import grid_anchors
    from online_detection_tpu_torch.models.detector import DetectorConfig, detect_batched
    from online_detection_tpu_torch.pipelines.device_pipeline import (
        harvest_dataset_device, train_online_modules_device)
    from online_detection_tpu_torch.pipelines.online_pipeline import (
        OnlineTrainConfig, run_inference)

    cfg, dcfg = OnlineTrainConfig(), DetectorConfig()
    h, w = CANVAS
    anchors = torch.from_numpy(grid_anchors(h // 16, w // 16)).cuda()
    test_set = teaching_set(HELD_OUT_IMAGES, seed + 1)
    batch = torch.from_numpy(np.stack([test_set.load_image(i)
                                       for i in range(BATCH_SIZE)])).cuda()
    sizes = torch.tensor([[w, h]] * BATCH_SIZE, dtype=torch.float32, device="cuda")

    def batch_ms(online):
        return [timed(lambda: detect_batched(params, online, anchors, batch, sizes, dcfg, True),
                      1) for _ in range(5)]

    def mask_summary(online):
        """Mean mask probability and share of pixels over 0.5 in the valid
        detections of the batch."""
        dets, masks, _, _ = detect_batched(params, online, anchors, batch, sizes, dcfg, True)
        m = masks[dets.valid]
        return {"mean": float(m.mean()), "over_half": float((m > 0.5).float().mean()),
                "detections": int(dets.valid.sum())}

    bf16_ms = batch_ms(trained)
    bf16_masks = mask_summary(trained)
    saved = os.environ.get("ODTPU_COMPUTE_DTYPE")
    os.environ["ODTPU_COMPUTE_DTYPE"] = "float32"
    paths = {}
    try:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        (state, _), harvest_s, paths["f32 harvest"] = launches_of(
            lambda: harvest_dataset_device(gen, params, teaching_set(TRAIN_IMAGES, seed), cfg,
                                           CANVAS, dcfg=dcfg, batch_size=BATCH_SIZE))
        online, train_s, paths["f32 train"] = launches_of(
            lambda: train_online_modules_device(gen, [state], cfg))
        del state
        (results, _), infer_s, paths["f32 run_inference"] = launches_of(
            lambda: run_inference(params, online, test_set, CANVAS, dcfg,
                                  batch_size=BATCH_SIZE))
        f32_ms = batch_ms(online)
        f32_masks = mask_summary(online)
        (results_bf16_models, _), _, paths["f32 trunk, bf16 models"] = launches_of(
            lambda: run_inference(params, trained, test_set, CANVAS, dcfg,
                                  batch_size=BATCH_SIZE))
    finally:
        if saved is None:
            del os.environ["ODTPU_COMPUTE_DTYPE"]
        else:
            os.environ["ODTPU_COMPUTE_DTYPE"] = saved
    bf16_paths = dict(report["training"]["launches"], **{"run_inference":
                                                         report["inference"]["launches"]})
    for k, ref in (("harvest", "harvest"), ("train", "train"),
                   ("run_inference", "run_inference")):
        if paths[f"f32 {k}"] != bf16_paths[ref]:
            fail(f"f32 trunk {k} launched {paths[f'f32 {k}']}, the bf16 run "
                 f"{bf16_paths[ref]}")
    check_map_values(results, "run_inference with the f32 trunk")
    for name in ("rpn", "detector", "mask"):
        f, b = getattr(online, name).falkon, getattr(trained, name).falkon
        if not torch.equal(f.exists, b.exists):
            fail(f"f32 trunk: {name} exists {f.exists.tolist()}, the bf16 run's "
                 f"{b.exists.tolist()}")
        if not (torch_isfinite(f.centers) and torch_isfinite(f.alpha)):
            fail(f"f32 trunk: the {name} models are not finite")
    check_map_values(results_bf16_models, "run_inference with the f32 trunk and the bf16 models")
    bf16 = {k: report["inference"][k] for k in ("det_map_0.5", "segm_map_0.5")}
    f32 = {k: results[k] for k in ("det_map_0.5", "segm_map_0.5")}
    f32_bf16_models = {k: results_bf16_models[k] for k in ("det_map_0.5", "segm_map_0.5")}
    report["f32_trunk"] = {
        "card": card, "maps_f32": f32, "maps_bf16": bf16,
        "maps_f32_trunk_bf16_models": f32_bf16_models,
        "ap_f32": {k: [float(a) for a in results[k]] for k in ("det_ap_0.5", "segm_ap_0.5")},
        "ap_bf16": report["inference"]["per_class_ap"], "harvest_s": harvest_s,
        "train_s": train_s, "run_inference_s": infer_s, "batch_ms_f32": f32_ms,
        "batch_ms_bf16": bf16_ms, "masks_f32": f32_masks, "masks_bf16": bf16_masks,
        "launches": paths}
    print(f"f32 trunk (ODTPU_COMPUTE_DTYPE=float32), device route on the same images: det / "
          f"segm mAP@0.5 {f32['det_map_0.5']:.4f} / {f32['segm_map_0.5']:.4f} (bf16 trunk "
          f"{bf16['det_map_0.5']:.4f} / {bf16['segm_map_0.5']:.4f}; f32 trunk with the bf16 "
          f"models {f32_bf16_models['det_map_0.5']:.4f} / "
          f"{f32_bf16_models['segm_map_0.5']:.4f}); harvest {harvest_s:.3f} s, "
          f"training {train_s:.3f} s, run_inference {infer_s:.3f} s; detect_batched a batch "
          f"of {BATCH_SIZE}: f32 {float(np.median(f32_ms)):.2f} ms, bf16 "
          f"{float(np.median(bf16_ms)):.2f} ms (median of 5) on {card}", flush=True)
    per_class = {k: [round(a, 4) for a in v[1:]] for k, v in report["f32_trunk"]["ap_f32"].items()}
    print(f"  per-class AP@0.5 with the f32 trunk {json.dumps(per_class)}; mask probabilities "
          f"of a held-out batch's detections: f32 {f32_masks}, bf16 {bf16_masks}", flush=True)
    return paths


def experiment_clis(work, card, keep, summary):
    """The serial, O-RPN + OOD (``--no_rpn``), segmentation (GT boxes) and
    visualizer CLIs once each on the flagship CLI's tree; the visualizer
    over the models the device-route run saved. Each run's kernels must
    launch; segmentation with GT boxes must give det mAP > 0.99, and the
    visualizer must write its PNGs (copied to ``cli/viz``)."""
    import math

    from online_detection_tpu_torch.experiments import (
        run_experiment_online_rpn_ood, run_experiment_online_rpn_ood_oos_serial,
        run_experiment_segmentation, visualize_masks_online_segmentation)

    feat, online = str(work / "feat.yaml"), str(work / "online.yaml")
    runs = (
        ("serial", run_experiment_online_rpn_ood_oos_serial.main,
         ["--config_file_feature_extraction", feat, "--config_file_rpn", feat,
          "--config_file_online_rpn_detection_segmentation", online]),
        ("O-RPN + OOD, --no_rpn", run_experiment_online_rpn_ood.main,
         ["--config_file_feature_extraction", feat, "--config_file_rpn_detection", online,
          "--no_rpn"]),
        ("segmentation, GT boxes", run_experiment_segmentation.main,
         ["--config_file_feature_extraction", feat,
          "--config_file_online_detection_segmentation", online,
          "--eval_segm_with_gt_bboxes"]),
    )
    paths = {}
    for name, main, args in runs:
        out = work / name.split(",")[0].replace(" ", "_").replace("+", "")
        results, run_s, launches = launches_of(
            lambda: main(["--output_dir", str(out)] + args))
        check_launches(f"CLI ({name})", launches, set(ONLINE_COUNTERS))
        paths[f"cli {name}"] = launches
        (keep / f"{out.name}.txt").write_text((out / "result.txt").read_text())
        maps = {k: v for k, v in results.items() if k.endswith("map_0.5")}
        if not maps or not all(math.isfinite(v) for v in maps.values()):
            fail(f"CLI ({name}) mAPs {maps}")
        if name.startswith("segmentation") and maps["det_map_0.5"] <= 0.99:
            fail(f"segmentation CLI with GT boxes: det mAP@0.5 {maps['det_map_0.5']}")
        summary[name] = {"seconds": run_s, "launches": launches, **maps}
        print(f"  CLI ({name}): {run_s:.2f} s, mAP@0.5 "
              f"{ {k: round(v, 4) for k, v in maps.items()} }, launches {launches} on {card}",
              flush=True)
    viz = work / "viz"
    written, run_s, launches = launches_of(lambda: visualize_masks_online_segmentation.main(
        ["--models_dir", str(work / "device"), "--output_dir", str(viz),
         "--config_file_feature_extraction", feat, "--num_images", "4"]))
    check_launches("CLI (visualizer)", launches, set(ONLINE_COUNTERS) - {"roi_align_fused2"},
                   {"stem_pool": 4, "roi_align": 8})
    pngs = sorted(p.name for p in viz.glob("*.png"))
    if len(pngs) != 4 or len(written) != 4:
        fail(f"visualizer CLI wrote {pngs}")
    shutil.copytree(viz, keep / "viz")
    paths["cli visualizer"] = launches
    summary["visualizer"] = {"seconds": run_s, "launches": launches, "pngs": pngs}
    print(f"  CLI (visualizer): {run_s:.2f} s, wrote {pngs}, launches {launches} on {card}",
          flush=True)
    return paths


# ---------------------------------------------------------------------------
# the device mesh and the canvas prefetcher


def reservoir_mismatches(a, b) -> list:
    """The fields of two harvests' reservoirs that are not bit-identical
    (every pool's rows, scratch included, counts and attempts; the AR sum,
    image count and drop count)."""
    import dataclasses

    import torch

    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            if (x is None) != (y is None):
                bad.append(f.name)
            continue
        parts = ((x.rows, y.rows), (x.counts, y.counts), (x.attempted, y.attempted)) \
            if hasattr(x, "rows") else ((x, y),)
        if not all(torch.equal(u, v) for u, v in parts):
            bad.append(f.name)
    return bad


def head_probes(online, rng, n=512):
    """Probe rows for each FALKON head: its first classes' centers plus
    noise at the kernel's scale, so the scores are not all near 0."""
    import torch

    out = {}
    for name in ("rpn", "detector", "mask"):
        fm = getattr(online, name).falkon
        c, m, d = fm.centers.shape
        pick = torch.from_numpy(rng.integers(0, c * m, size=n)).to(fm.centers.device)
        x = fm.centers.reshape(c * m, d)[pick]
        out[name] = x + torch.randn(x.shape, device=x.device) * (0.5 * fm.sigma / d ** 0.5)
    return out


# the JAX mesh tests' tolerances (rtol and atol): FALKON scores; RLS mu,
# beta, t_inv
MESH_TOL = {"scores": 1e-4, "rls mu": 1e-5, "rls beta": 2e-3, "rls t_inv": 1e-4}


def compare_models(got, want, probes, what, fields=tuple(MESH_TOL)):
    """Holds ``got`` to ``want``: every head's ``exists`` identical, and each
    of ``fields`` (its scores on its probe, the RLS mu, beta and t_inv)
    within its MESH_TOL (rtol and atol). Returns the max |difference| of
    every one of them, held or not."""
    import torch

    from online_detection_tpu_torch.solvers.falkon import falkon_predict_classes

    diffs = {}
    with torch.inference_mode():
        for name, x in probes.items():
            g, w = getattr(got, name), getattr(want, name)
            if not torch.equal(g.falkon.exists, w.falkon.exists):
                fail(f"{what}: {name} exists {g.falkon.exists.tolist()} against "
                     f"{w.falkon.exists.tolist()}")
            pairs = [("scores", falkon_predict_classes(g.falkon, x),
                      falkon_predict_classes(w.falkon, x))]
            if getattr(g, "rls", None) is not None:
                pairs += [(f"rls {f}", getattr(g.rls, f), getattr(w.rls, f))
                          for f in ("mu", "beta", "t_inv")]
            for field, a, b in pairs:
                diffs[f"{name} {field}"] = float((a - b).abs().max())
                tol = MESH_TOL[field]
                if field in fields and not torch.allclose(a, b, rtol=tol, atol=tol):
                    fail(f"{what}: {name} {field} differs by {diffs[f'{name} {field}']:.3e} "
                         f"(tolerance {tol})")
    return diffs


MESH_MAP_TOL = 0.002


def clone_reservoirs(state):
    """A copy of a harvest's reservoirs (training consumes them)."""
    import dataclasses

    from online_detection_tpu_torch.engine.device_accumulate import Pool

    def copy_of(x):
        if isinstance(x, Pool):
            return Pool(x.rows.clone(), x.counts.clone(),
                        None if x.attempted is None else x.attempted.clone())
        return None if x is None else x.clone()

    return state.replace(**{f.name: copy_of(getattr(state, f.name))
                            for f in dataclasses.fields(state)})


@contextlib.contextmanager
def trunk_in_slices(n_slices):
    """A context in which the device route's harvest runs its trunk on each
    of ``n_slices`` equal slices of a canvas batch in turn, on one device,
    and concatenates the outputs: what a mesh of that many entries computes
    on the card, without the mesh."""
    import torch

    from online_detection_tpu_torch.pipelines import device_pipeline

    plain = device_pipeline.harvest_trunk

    def sliced(params, online_rpn, anchors, images, sizes, gt_boxes, gt_valid, *rest):
        k = images.shape[0] // n_slices
        parts = [plain(params, online_rpn, anchors, images[i:i + k], sizes[i:i + k],
                       gt_boxes[i:i + k], gt_valid[i:i + k], *rest)
                 for i in range(0, images.shape[0], k)]
        return tuple(None if parts[0][j] is None else torch.cat([p[j] for p in parts])
                     for j in range(5))

    device_pipeline.harvest_trunk = sliced
    try:
        yield
    finally:
        device_pipeline.harvest_trunk = plain


def mesh_phase(params, trained, seed, card, report, mesh=None):
    """The device mesh: ``mesh``, by default two entries on one card,
    ``Mesh(devices=[cuda:0, cuda:0])`` (``tools/mesh_cards.py`` passes one
    entry a card).

    On the card a bf16 convolution's rounding and a batched product's
    depend on the batch's size (cuDNN and cuBLAS pick kernels by shape), and
    the minibootstrap's mining thresholds turn a rounding difference into
    another cache. So each mesh path is held to the unsharded path at the
    mesh's per-device size, and the plain batch-8 / chunk-8 results are
    printed beside it.

    Harvest: the 64 teaching images, each canvas batch of 8 split over the
    mesh (4 + 4 on two entries);
    its reservoirs must be bit-identical to those of the unsharded harvest
    whose trunk runs the same two slices in turn (``trunk_in_slices``).
    Training: one harvest's reservoirs trained on the mesh (every head's
    classes, windows of 8, split over the mesh; the grouped RLS too) and
    unsharded with ``solver_class_chunk`` 8 / entries, from the same draws
    (``compare_models``); with ``trained`` (the training phase's chunk-8
    models), exists and the RLS held against it too. Inference:
    ``run_inference`` over the 32 held-out images with the mesh-trained
    models, on the mesh at batch 8 and unsharded at batch 8 / entries: det
    and segm mAP@0.5 within MESH_MAP_TOL. Every kernel launches once per
    device slice: entries times as often as unsharded at batch 8. Returns
    each mesh path's launches."""
    import numpy as np
    import torch

    from online_detection_tpu_torch.models.detector import DetectorConfig
    from online_detection_tpu_torch.parallel.mesh import Mesh
    from online_detection_tpu_torch.pipelines.device_pipeline import (
        harvest_dataset_device, train_online_modules_device)
    from online_detection_tpu_torch.pipelines.online_pipeline import (
        OnlineTrainConfig, run_inference)

    mesh = mesh or Mesh(devices=[torch.device("cuda", 0)] * 2)
    n_dev = mesh.size
    cfg, dcfg = OnlineTrainConfig(), DetectorConfig()
    ds = teaching_set(TRAIN_IMAGES, seed)
    n_batches = -(-TRAIN_IMAGES // BATCH_SIZE)
    paths, rec = {}, {"card": card, "mesh": [str(d) for d in mesh.devices]}

    def harvest(mesh_or_none):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        state, meta = harvest_dataset_device(gen, params, ds, cfg, CANVAS, dcfg=dcfg,
                                             batch_size=BATCH_SIZE, mesh=mesh_or_none)
        return state, meta, gen

    with trunk_in_slices(mesh.size):
        state_sliced, _, _ = harvest(None)
    (state_mesh, meta_mesh, _), rec["harvest_s"], paths["mesh harvest"] = launches_of(
        lambda: harvest(mesh))
    check_launches("harvest on the mesh", paths["mesh harvest"],
                   {"stem_pool", "roi_align_fused2"},
                   {"stem_pool": n_dev * n_batches, "roi_align_fused2": n_dev * n_batches})
    bad = reservoir_mismatches(state_sliced, state_mesh)
    if bad:
        fail(f"the mesh harvest's reservoirs differ from those of the unsharded harvest with "
             f"the trunk in the mesh's slices, in {bad}")
    del state_sliced
    (state_one, meta_one, gen_one), rec["harvest_unsharded_s"] = timed_call(
        lambda: harvest(None))
    rec["harvest_against_batch_8"] = {
        "fields_not_bit_identical": reservoir_mismatches(state_one, state_mesh),
        "rows": {k: [int(getattr(s, k).counts.sum()) for s in (state_one, state_mesh)]
                 for k in ("rpn_pos", "rpn_neg", "det_pos", "det_neg", "det_coxy",
                           "mask_pos", "mask_neg")},
        "average_recall": [meta_one["average_recall"], meta_mesh["average_recall"]]}
    del state_mesh

    def generator():  # the draws the harvest left, for each training
        gen = torch.Generator(device="cuda")
        gen.set_state(draws)
        return gen

    draws = gen_one.get_state()
    state_copy = clone_reservoirs(state_one)
    cards = len(set(mesh.devices)) > 1
    state_card = clone_reservoirs(state_one) if cards else None
    per_device = cfg.solver_class_chunk // mesh.size
    online_one, rec["train_unsharded_s"] = timed_call(lambda: train_online_modules_device(
        generator(), [state_one], cfg._replace(solver_class_chunk=per_device)))
    del state_one
    online_mesh, rec["train_s"], paths["mesh train"] = launches_of(
        lambda: train_online_modules_device(generator(), [state_copy], cfg, mesh=mesh))
    del state_copy
    mining = n_dev * mining_launches(cfg, 20, BATCH_SIZE)
    check_launches("training on the mesh", paths["mesh train"], {"gaussian_mmv", "tf32_split"},
                   {"gaussian_mmv": mining, "tf32_split": mining})
    probes = head_probes(online_one, np.random.default_rng(seed + 5))
    if cards:
        # the same sharded program with every entry on the first card: a
        # mesh across cards must equal it; the unsharded RLS solves all
        # classes in one batch, which rounds otherwise than n_dev batches
        online_card = train_online_modules_device(
            generator(), [state_card], cfg, mesh=Mesh(devices=[mesh.first] * n_dev))
        del state_card
        rec["models_against_one_card"] = compare_models(
            online_mesh, online_card, probes, "mesh models against the mesh on one card")
        del online_card
    rec["models_against_per_device_chunk"] = compare_models(
        online_mesh, online_one, probes, f"mesh models against chunk {per_device}",
        fields=("scores",) if cards else tuple(MESH_TOL))
    if trained is not None:
        # the training phase's models: the same reservoirs and draws, windows
        # of 8 unsharded: exists and the RLS held, the FALKON scores printed
        rec["models_against_chunk_8"] = compare_models(
            online_mesh, trained, probes, "mesh models against chunk 8",
            fields=("rls mu", "rls beta", "rls t_inv"))
    del online_one, probes

    test_set = teaching_set(HELD_OUT_IMAGES, seed + 1)
    (results, preds), rec["inference_s"], paths["mesh inference"] = launches_of(
        lambda: run_inference(params, online_mesh, test_set, CANVAS, dcfg,
                              batch_size=BATCH_SIZE, mesh=mesh))
    n_test = -(-HELD_OUT_IMAGES // BATCH_SIZE)
    check_launches("run_inference on the mesh", paths["mesh inference"],
                   {k for k, v in EXPECTED_LAUNCHES.items() if v},
                   {n: n_dev * n_test * v for n, v in EXPECTED_LAUNCHES.items()})
    check_map_values(results, "run_inference on the mesh")
    if len(preds) != HELD_OUT_IMAGES:
        fail(f"run_inference on the mesh gave {len(preds)} predictions")
    (ref, _), rec["inference_unsharded_s"] = timed_call(lambda: run_inference(
        params, online_mesh, test_set, CANVAS, dcfg, batch_size=BATCH_SIZE // n_dev))
    keys = ("det_map_0.5", "segm_map_0.5")
    rec["maps"] = {m: results[m] for m in keys}
    rec["maps_unsharded_per_device_batch"] = {m: ref[m] for m in keys}
    if "inference" in report:
        rec["maps_inference_stage"] = {m: report["inference"][m] for m in keys}
    rec["launches"] = paths
    report["mesh"] = rec

    def short(d):
        return json.dumps({k: float(f"{v:.3g}") for k, v in d.items()})

    print(f"  mesh {rec['mesh']}: harvest {rec['harvest_s']:.3f} s (unsharded at batch 8 "
          f"{rec['harvest_unsharded_s']:.3f} s), reservoirs bit-identical "
          f"to the unsharded harvest's with the trunk in {n_dev} slices; against the plain "
          f"batch-8 harvest {json.dumps(rec['harvest_against_batch_8'])}", flush=True)
    print(f"  mesh training {rec['train_s']:.3f} s (unsharded at chunk {per_device} "
          f"{rec['train_unsharded_s']:.3f} s); against the mesh on one card "
          f"{short(rec.get('models_against_one_card', {}))}; against unsharded at "
          f"chunk {per_device} {short(rec['models_against_per_device_chunk'])}; against the "
          f"training phase's chunk 8 {short(rec.get('models_against_chunk_8', {}))}",
          flush=True)
    print(f"  run_inference on the mesh {rec['inference_s']:.3f} s (unsharded at batch "
          f"{BATCH_SIZE // n_dev} {rec['inference_unsharded_s']:.3f} s): det / segm mAP@0.5 "
          f"{rec['maps']['det_map_0.5']:.4f} / {rec['maps']['segm_map_0.5']:.4f}; unsharded "
          f"at batch {BATCH_SIZE // n_dev} {json.dumps(rec['maps_unsharded_per_device_batch'])}; "
          f"the inference stage's (chunk-8 models, batch 8) "
          f"{json.dumps(rec.get('maps_inference_stage'))}; launches {paths} on {card}",
          flush=True)
    for m in keys:
        if abs(rec["maps"][m] - ref[m]) > MESH_MAP_TOL:
            fail(f"run_inference on the mesh: {m} {rec['maps'][m]:.4f} against the unsharded "
                 f"{ref[m]:.4f} at batch {BATCH_SIZE // n_dev} (tolerance {MESH_MAP_TOL})")
    return paths


class JpegTeachingSet:
    """The teaching set's images written as JPEG files (quality 95, PIL)
    and read back with PIL, with its annotations and masks; ``image_path``
    names each file."""

    def __init__(self, base, directory: Path):
        from PIL import Image

        self.base, self.paths = base, []
        directory.mkdir(parents=True, exist_ok=True)
        for i in range(len(base)):
            path = directory / f"{base.ids[i]}.jpg"
            Image.fromarray(base.images[i]).save(path, "JPEG", quality=95)
            self.paths.append(str(path))

    def __len__(self):
        return len(self.paths)

    def image_path(self, i):
        return self.paths[i]

    def load_image(self, i):
        import numpy as np
        from PIL import Image

        with Image.open(self.paths[i]) as im:
            return np.asarray(im.convert("RGB"))

    def get_annotation(self, i):
        return self.base.get_annotation(i)

    def load_masks(self, i, anno=None):
        return self.base.load_masks(i, anno)


def prefetch_phase(params, seed, card, report):
    """``harvest_dataset_device`` at batch 8 over the 64 teaching images
    written as 800x600 JPEGs, with the canvases loaded on the calling thread
    (``prefetch=None``) and by the thread pool (``"threads"``), in the order
    None, threads, threads, None: the reservoirs must be bit-identical; ms
    per image of each. Returns the runs' launches."""
    import torch

    from online_detection_tpu_torch.models.detector import DetectorConfig
    from online_detection_tpu_torch.pipelines.device_pipeline import harvest_dataset_device
    from online_detection_tpu_torch.pipelines.online_pipeline import OnlineTrainConfig

    cfg, dcfg = OnlineTrainConfig(), DetectorConfig()
    work = ROOT / ".bench" / "prefetch"
    shutil.rmtree(work, ignore_errors=True)
    paths, ms, kept = {}, {None: [], "threads": []}, {}
    try:
        t0 = time.time()
        ds = JpegTeachingSet(teaching_set(TRAIN_IMAGES, seed), work)
        write_s = time.time() - t0
        t0 = time.time()
        for i in range(len(ds)):
            ds.load_image(i)
        decode_ms = (time.time() - t0) / len(ds) * 1e3
        for k, mode in enumerate((None, "threads", "threads", None)):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            (state, _), s, launches = launches_of(
                lambda: harvest_dataset_device(gen, params, ds, cfg, CANVAS, dcfg=dcfg,
                                               batch_size=BATCH_SIZE, prefetch=mode))
            paths[f"jpeg harvest {k} ({mode})"] = launches
            ms[mode].append(s / len(ds) * 1e3)
            if k < 2:
                kept[mode] = state
            del state
            if k == 1:
                bad = reservoir_mismatches(kept[None], kept["threads"])
                kept.clear()
                if bad:
                    fail(f"prefetch='threads' changed the reservoirs: {bad}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    for launches in paths.values():
        check_launches("the JPEG-fed harvest", launches, {"stem_pool", "roi_align_fused2"},
                       {"stem_pool": -(-TRAIN_IMAGES // BATCH_SIZE),
                        "roi_align_fused2": -(-TRAIN_IMAGES // BATCH_SIZE)})
    mean = {str(k): sum(v) / len(v) for k, v in ms.items()}
    report["prefetch"] = {"card": card, "jpeg_write_s": write_s, "pil_decode_ms": decode_ms,
                          "ms_per_image": {str(k): v for k, v in ms.items()},
                          "mean_ms_per_image": mean,
                          "saving": 1.0 - mean["threads"] / mean["None"]}
    print(f"  JPEG-fed harvest of {TRAIN_IMAGES} 800x600 JPEGs at batch {BATCH_SIZE}: ms per "
          f"image, canvases on the calling thread {[round(v, 3) for v in ms[None]]}, on the "
          f"thread pool {[round(v, 3) for v in ms['threads']]} (reservoirs bit-identical; "
          f"{report['prefetch']['saving']:.1%} less); PIL decode alone {decode_ms:.2f} ms an "
          f"image on the host; on {card}", flush=True)
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA card")
    if not (ROOT / "online_detection_tpu_torch" / "csrc").is_dir():
        fail(f"no online_detection_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from online_detection_tpu_torch.models.anchors import grid_anchors
    from online_detection_tpu_torch.models.detector import (
        DetectorConfig, detect_batched, init_detector_params)
    from online_detection_tpu_torch.ops import _build
    from online_detection_tpu_torch.utils.device import ieee_fp32

    t_start = time.time()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    card = card_line()
    dev = torch.device("cuda")
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.time()
    started = start_replaced_backward(_build)  # built beside the port's kernels
    try:
        logs = _build.build_all(KERNELS)
        replaced_backward, logs["roi_align_backward (replaced)"] = load_replaced_backward(
            started, _build)
    finally:
        if started[0].poll() is None:
            started[0].kill()
            started[0].wait()
    for k in KERNELS:
        _build.load(k)
    print(f"built {len(KERNELS)} kernels and the replaced RoIAlign backward in "
          f"{time.time() - t0:.1f} s", flush=True)
    for k, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k}: {line.strip()}", flush=True)
    sass = {"gaussian_mmv": tensor_core_sass("gaussian_mmv", "mmv_tf32x3_kernel", "HGMMA",
                                             ".TF32"),
            "stem_pool": tensor_core_sass("stem_pool", "stem_kernel_mma", "HMMA", ".BF16")}
    for k, v in sass.items():
        print(f"  {k} SASS: {v['count']} tensor-core instructions, e.g. {v['first']}",
              flush=True)

    rng = np.random.default_rng(args.seed)
    b, (h, w) = BATCH_SIZE, CANVAS
    t0 = time.time()
    params = init_detector_params(args.seed, N_ANCHORS, N_CLASSES + 1).to(dev)
    cfg = DetectorConfig()
    anchors = torch.from_numpy(grid_anchors(h // 16, w // 16)).to(dev)
    sizes = torch.tensor([[w, h]] * b, dtype=torch.float32, device=dev)

    def canvases():
        return torch.from_numpy(rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8)).to(dev)

    with torch.inference_mode(), ieee_fp32():
        online, inputs = build_online(rng, params, canvases(), sizes, anchors, cfg, dev)
    torch.cuda.synchronize()
    print(f"set-up (weights, on-line models from a first batch) {time.time() - t0:.1f} s",
          flush=True)

    report = {}
    print("kernels vs plain versions on the card:", flush=True)
    with torch.inference_mode(), ieee_fp32():
        check_mmv(inputs, report)
        check_mmv_mining_rows(args.seed, report)
        check_stem(params, inputs, report)
        check_stem_shapes(args.seed, report)
        check_roi(inputs, report)
        check_roi_adversarial(args.seed, report)
    del inputs
    torch.cuda.empty_cache()

    batches = [canvases() for _ in range(BATCHES)]
    torch.cuda.synchronize()
    _build.reset_launches()
    times = []
    n_valid = []
    for images in batches:
        t0 = time.time()
        dets, masks, props, pvalid = detect_batched(params, online, anchors, images, sizes,
                                                    cfg, True)
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
        n_valid.append(check_detections(dets, masks, props, pvalid, b, cfg))
    launches = dict(_build.LAUNCHES)
    report["inference_launches"] = dict(launches)
    for k, per in EXPECTED_LAUNCHES.items():
        if launches[k] != per * BATCHES:
            fail(f"{k} launched {launches[k]} times on the main path, "
                 f"expected {per * BATCHES}")
    print(f"detect_batched {b}x{h}x{w}: ms/batch {[round(t, 3) for t in times]} "
          f"valid detections {n_valid} launches {launches} on {card}", flush=True)

    profiled = profile_batch(
        lambda: detect_batched(params, online, anchors, batches[0], sizes, cfg, True),
        out_dir / "detect_profile.txt", card)
    print(f"profile of one batch: {json.dumps(profiled)}", flush=True)

    small_reference_check(params, online, dev, report)
    del online, batches
    torch.cuda.empty_cache()

    print("training path:", flush=True)
    with torch.inference_mode(), ieee_fp32():
        ds = teaching_set(TRAIN_IMAGES, args.seed)
        c4, rois = harvest_inputs(params, ds, cfg, dev)
        check_fused2(c4, rois, report)
        del c4, rois
    trained, _, train_paths = training_phase(params, args.seed, card, report, out_dir)
    with torch.inference_mode(), ieee_fp32():
        from online_detection_tpu_torch.pipelines.online_pipeline import OnlineTrainConfig

        check_mmv_mining(trained, OnlineTrainConfig(), report, rng)
    mfu_lines(times, profiled, card, report)
    print("inference stage:", flush=True)
    infer_launches = inference_phase(params, trained, args.seed, card, report, out_dir)
    small_inference_reference_check(params, trained, args.seed, dev, report)
    print("the device mesh (two entries on one card):", flush=True)
    mesh_paths = mesh_phase(params, trained, args.seed, card, report)
    print("the canvas prefetcher:", flush=True)
    mesh_paths.update(prefetch_phase(params, args.seed, card, report))
    print("the demo and the incremental teacher:", flush=True)
    api_paths = demo_phase(params, trained, args.seed, card, report)
    print("the trunk in f32:", flush=True)
    api_paths.update(f32_trunk_phase(params, trained, args.seed, card, report))
    del trained
    torch.cuda.empty_cache()
    small_training_reference_check(params, dev, report)
    print("host route:", flush=True)
    host_paths, det_pools, host_online = host_route_phase(params, args.seed, card, report,
                                                          out_dir)
    print("the module facades:", flush=True)
    api_paths.update(facades_phase(params, det_pools, host_online, args.seed, card,
                                       report))
    del det_pools, host_online
    host_paths.update(feature_cache_phase(params, args.seed, card, report))
    print("flagship CLI:", flush=True)
    flagship_paths, cli_paths = cli_phase(card, report, out_dir)
    host_paths.update(flagship_paths)
    api_paths.update(cli_paths)
    print("checkpoint files and the stock path:", flush=True)
    host_paths.update(pretrained_phase(args.seed, card, report, out_dir))
    print("the SGD baselines:", flush=True)
    host_paths.update(sgd_phase(args.seed, card, report, out_dir, dev, replaced_backward))
    for path in (list(train_paths.values()) + [infer_launches] + list(host_paths.values())
                 + list(api_paths.values()) + list(mesh_paths.values())):
        for k, n in path.items():
            launches[k] += n

    b1 = report["gaussian_mmv"]
    print(f"B1 at its six main-path calls: {b1['ms']:.3f} ms (SIMT fp32 kernel: "
          f"{sum(SIMT_B1_MS.values()):.2f} ms; 3xTF32 bound {b1['bound_ms']:.3f} ms, fp32 "
          f"bound {b1['bound_fp32_ms']:.3f} ms) on {card}", flush=True)
    b3, b4 = report["roi_align"], report["roi_align_fused2"]
    print(f"B3 per inference batch: {b3['ms']:.3f} ms (replaced kernel "
          f"{REPLACED_ROI_MS['proposals'] + REPLACED_ROI_MS['detections']:.3f} ms; bound "
          f"{b3['bound_ms']:.3f} ms); B4 per harvest batch: {b4['ms']:.3f} ms (replaced kernel "
          f"{REPLACED_ROI_MS['harvest']:.3f} ms; bound {b4['bound_ms']:.3f} ms) on {card}",
          flush=True)
    bw = report["roi_align_backward"]
    print(f"RoIAlign backward per training step: {bw['ms']:.4f} ms (replaced kernel "
          f"{bw['replaced_ms']:.4f} ms here, {REPLACED_BACKWARD_MS:.3f} ms recorded; plain "
          f"{bw['plain_ms']:.3f} ms; bound "
          f"{bw['bound_ms']:.4f} ms, {bw['bound_by']}: {bw['bound_ms'] / bw['ms']:.0%} of it) on "
          f"{card}", flush=True)

    replaces = {  # the split is B1's operand preparation
        "gaussian_mmv": "online_detection_tpu/ops/gaussian_mmv.py:219",
        "tf32_split": "online_detection_tpu/ops/gaussian_mmv.py:219",
        "stem_pool": "online_detection_tpu/ops/stem_pool.py:150",
        "roi_align": "online_detection_tpu/ops/roi_align.py:175",
        "roi_align_fused2": "online_detection_tpu/ops/roi_align.py:311",
        # the gradient of the function B3 computes, which the JAX trainer
        # takes with jax.grad of roi_align (XLA; no Pallas backward exists)
        "roi_align_backward": "online_detection_tpu/ops/roi_align.py:73",
    }
    # the stock path's calls: B2's fp32 route and B3 at its shapes
    bw = report["roi_align_backward"]
    extra = {"stem_pool": {"f32_route": report["stem_pool"]["f32_route"],
                           "f32_route_train": report["stem_pool"]["f32_route_train"],
                           "grad": report["stem_pool"]["grad"]},
             "roi_align": {"pretrained_calls": report["roi_align"]["pretrained_calls"]},
             "roi_align_backward": {k: bw[k] for k in (
                 "replaced_ms", "tolerance", "adversarial_max_abs_err", "autograd_max_abs_err",
                 "odd_shapes_max_abs_err")} | {
                 "run_to_run_max_abs_diff": bw["calls"][0]["run_to_run_max_abs_diff"],
                 "footprint_cells_mean": bw["calls"][0]["footprint_cells_mean"],
                 "stress": {k: {m: v[m] for m in ("ms", "replaced_ms", "max_abs_err",
                                                  "footprint_cells_mean")}
                            for k, v in bw["stress"].items()}}}
    sources = {k: k for k in KERNELS}
    sources["tf32_split"] = "gaussian_mmv"
    line = {"kernels": [
        {"name": k, "route": "cuda",
         "source": f"online_detection_tpu_torch/csrc/{sources[k]}.cu",
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": report[k]["max_abs_err"], "ms": report[k]["ms"],
         "plain_ms": report[k]["plain_ms"], "bound_ms": report[k]["bound_ms"],
         "bound_by": report[k]["bound_by"], "library_ms": None,
         # this kernel's launches on each path of the module API's phases (the
         # demo and teacher, the f32 trunk, the facades, the other CLIs)
         "api_launches": {p: n[k] for p, n in api_paths.items() if n[k]},
         # its launches on the mesh's paths and the JPEG-fed harvests
         "mesh_launches": {p: n[k] for p, n in mesh_paths.items() if n[k]},
         **extra.get(k, {})}
        for k in COUNTERS],
        "not_ported": []}
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": {k: report[k] for k in COUNTERS},
         "training": report["training"], "inference": report["inference"],
         "small_inference_reference": report["small_inference_reference"],
         "small_reference": report["small_reference"],
         "small_training_reference": report["small_training_reference"],
         "host_route": report["host_route"], "feature_cache": report["feature_cache"],
         "cli": report["cli"], "pretrained": report["pretrained"], "sgd": report["sgd"],
         "facades": report["facades"], "demo": report["demo"], "mfu": report["mfu"],
         "f32_trunk": report["f32_trunk"], "mesh": report["mesh"],
         "prefetch": report["prefetch"],
         "stem_pool_grad": report["stem_pool grad"],
         "ms_per_batch": times, "launches": launches,
         "valid_detections": n_valid, "profile": profiled, "build_logs": logs,
         "tensor_core_sass": sass,
         "seconds": time.time() - t_start}, indent=1))
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
