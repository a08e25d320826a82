#!/usr/bin/env python3
"""Chip smoke for the PyTorch + CUDA port (``online_detection_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed 0]

1. Builds the port's CUDA kernels from ``online_detection_tpu_torch/csrc``
   (one nvcc per source, all started together).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, and times both. B1 (3xTF32 on the tensor
   cores) must stay within 1e-5 of the sum of its terms' magnitudes of the
   IEEE fp32 plain version, its tf32 split must match its plain version bit
   for bit, and its bound is taken at the 3xTF32 rate (495 / 3 TFLOP/s).
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
   detections; holds B4 (the harvest RoIAlign) and B1 at the mining shapes
   against their plain versions; traces one harvest batch; and runs harvest
   and training on a few small canvases on the card and on the CPU with the
   same draws.
5. The inference stage: ``run_inference`` with the trained models over 32
   held-out synthetic 800x600 images at batch 8 (4 batches, each kernel's
   launch counter must rise by 4 batches' count), scored by VOC07 det and
   segm mAP@0.5 (finite, in [0, 1], det mAP not 0 and not under
   ``DET_MAP_FLOOR``); prints the mAPs, the per-class APs, images/s and ms
   per image (wall clock, loading and scoring included) and the seconds in
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
   device route's (det mAP 0 fails); traces the harvest of 4 images.
7. The feature caches: ``save_features`` of a host-route harvest of the
   first 8 teaching images, then ``load_features`` with the shuffle flags
   off (the pools must equal the saved rows) and on (each class's negatives
   must be a permutation of them); the cache is deleted afterwards.
8. The flagship CLI (``online_detection_tpu_torch.experiments.
   run_experiment_online_rpn_ood_oos``) on an on-disk synthetic tree (8
   train and 4 test JPEGs of 240x320, written and read with PIL): the
   device route saving its models, the host route saving the feature
   caches, and training from those caches; each must write the CLI's
   ``result.txt`` lines, give finite mAPs and launch the kernels of its
   path.
9. Prints one ``{"kernels": [...]}`` line (launches counted over every
   path), the card's name and power limit, and, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failed phase raises and exits non-zero, with no result line. Details
(compiler logs, per-call timings) go to ``chiprun_out/chip_smoke.json``, the
traced batches' device time by kernel and idle share to
``chiprun_out/detect_profile.txt``, ``chiprun_out/harvest_profile.txt`` and
``chiprun_out/inference_profile.txt``, and ``run_inference``'s ``result.txt``
and log to ``chiprun_out/inference/``.
Beside them, the host route's traced harvest goes to
``host_harvest_profile.txt`` and each CLI run's ``result.txt`` to ``cli/``.
Scratch files (the feature caches, the CLI's tree and outputs) live under
``.bench/`` and are deleted.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# CUDA sources, one library each
KERNELS = ("gaussian_mmv", "stem_pool", "roi_align", "roi_align_fused2")
# launch counters: B1 is two kernels of gaussian_mmv.cu, the centers' tf32
# split ("tf32_split") and the mmv itself, each launched once per call
COUNTERS = ("gaussian_mmv", "tf32_split", "stem_pool", "roi_align", "roi_align_fused2")
# per batch of detect_batched
EXPECTED_LAUNCHES = {"gaussian_mmv": 3, "tf32_split": 3, "stem_pool": 1, "roi_align": 2,
                     "roi_align_fused2": 0}
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
# det mAP@0.5 on them must reach this: half of the 0.3889 of its first run
# on the card (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md, section 6), so that a
# port fault that loses most detections fails while bf16 noise does not
DET_MAP_FLOOR = 0.19


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
                        "roi_align_kernel", "roi_align_fused2_kernel", "Memcpy")}
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
    def __init__(self, boxes, labels):
        import numpy as np

        self.boxes, self.labels = boxes, labels
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
        return _Anno(self.boxes[i], self.labels[i])

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
            "roi_align_fused2": n_batches}
    if paths["harvest"] != want:
        fail(f"harvest launched {paths['harvest']}, expected {want}")
    counts = pool_counts(state, cfg)
    print(f"harvest_dataset_device {TRAIN_IMAGES} images of {TRAIN_HW[1]}x{TRAIN_HW[0]} at "
          f"batch {BATCH_SIZE}: {harvest_s:.3f} s, {harvest_s / TRAIN_IMAGES * 1e3:.2f} ms/image "
          f"on {card}; AR {meta['average_recall']:.4f}, truncation {meta['truncation']}",
          flush=True)

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
            "roi_align_fused2": 0}
    if paths["train"] != want:
        fail(f"training launched {paths['train']}, expected {want}")
    trained = check_trained(online, counts, cfg)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"train_online_modules_device: {train_s:.3f} s; seconds by stage "
          f"{ {k: round(v, 3) for k, v in stages.items()} } on {card}; classes trained "
          f"{trained}; peak {peak_gb:.1f} GiB", flush=True)

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
        "harvest_profile": profiled}
    return online, ds, paths


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


def check_scores(results, where: str):
    """det and segm mAP@0.5 finite and within [0, 1]; det mAP not 0."""
    import math

    for k in ("det_map_0.5", "segm_map_0.5"):
        v = results[k]
        if not (math.isfinite(v) and 0.0 <= v <= 1.0):
            fail(f"{where}: {k} = {v}")
    if results["det_map_0.5"] == 0.0:
        fail(f"{where}: det mAP@0.5 is 0.0: the trained models detect nothing")


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
    check_scores(results, "run_inference")
    if results["det_map_0.5"] < DET_MAP_FLOOR:
        fail(f"det mAP@0.5 {results['det_map_0.5']:.4f} under its floor {DET_MAP_FLOOR}")
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
            "roi_align_fused2": TRAIN_IMAGES}
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
    del harvest
    paths["host train"] = dict(_build.LAUNCHES)
    mining = host_mining_launches(cfg, seg_iters)
    want = {"gaussian_mmv": mining, "tf32_split": mining, "stem_pool": 0, "roi_align": 0,
            "roi_align_fused2": 0}
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
    check_scores(results, "host route run_inference")
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
    return paths


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
    launch counters of the kernels its path runs must rise."""
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
    all_kernels = set(COUNTERS)
    runs = (("device route", "device", ["--save_RPN_detector_segmentation_models"],
             all_kernels),
            ("host route, save features", "host",
             ["--save_RPN_detector_segmentation_features"], all_kernels),
            ("host route, load features", "host",
             ["--load_RPN_detector_segmentation_features"], all_kernels - {"roi_align_fused2"}))
    paths, summary = {}, {}
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
            text = result.read_text()[len(before):]
            (keep / f"{name.replace(' ', '_').replace(',', '')}.txt").write_text(text)
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
    finally:
        shutil.rmtree(work, ignore_errors=True)
    report["cli"] = {"card": card, "tree_s": tree_s, "runs": summary}
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
    logs = _build.build_all(KERNELS)
    for k in KERNELS:
        _build.load(k)
    print(f"built {len(KERNELS)} kernels in {time.time() - t0:.1f} s", flush=True)
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
    print("inference stage:", flush=True)
    infer_launches = inference_phase(params, trained, args.seed, card, report, out_dir)
    small_inference_reference_check(params, trained, args.seed, dev, report)
    del trained
    torch.cuda.empty_cache()
    small_training_reference_check(params, dev, report)
    print("host route:", flush=True)
    host_paths = host_route_phase(params, args.seed, card, report, out_dir)
    host_paths.update(feature_cache_phase(params, args.seed, card, report))
    print("flagship CLI:", flush=True)
    host_paths.update(cli_phase(card, report, out_dir))
    for path in list(train_paths.values()) + [infer_launches] + list(host_paths.values()):
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

    replaces = {  # the split is B1's operand preparation
        "gaussian_mmv": "online_detection_tpu/ops/gaussian_mmv.py:219",
        "tf32_split": "online_detection_tpu/ops/gaussian_mmv.py:219",
        "stem_pool": "online_detection_tpu/ops/stem_pool.py:150",
        "roi_align": "online_detection_tpu/ops/roi_align.py:175",
        "roi_align_fused2": "online_detection_tpu/ops/roi_align.py:311",
    }
    sources = {k: k for k in KERNELS}
    sources["tf32_split"] = "gaussian_mmv"
    line = {"kernels": [
        {"name": k, "route": "cuda",
         "source": f"online_detection_tpu_torch/csrc/{sources[k]}.cu",
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": report[k]["max_abs_err"], "ms": report[k]["ms"],
         "plain_ms": report[k]["plain_ms"], "bound_ms": report[k]["bound_ms"],
         "bound_by": report[k]["bound_by"], "library_ms": None}
        for k in COUNTERS],
        "not_ported": []}
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": {k: report[k] for k in COUNTERS},
         "training": report["training"], "inference": report["inference"],
         "small_inference_reference": report["small_inference_reference"],
         "small_reference": report["small_reference"],
         "small_training_reference": report["small_training_reference"],
         "host_route": report["host_route"], "feature_cache": report["feature_cache"],
         "cli": report["cli"],
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
