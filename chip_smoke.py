#!/usr/bin/env python3
"""Chip smoke for the PyTorch + CUDA port (``online_detection_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed 0]

1. Builds the port's CUDA kernels from ``online_detection_tpu_torch/csrc``.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and times both.
3. Drives ``detect_batched`` at full width (R-50-C4 trunk from a numpy seed,
   15 anchors, 21 classes, FALKON widths of the flagship configuration) on
   3 batches of 8 synthetic 608x800 canvases, checks the outputs and that
   every kernel's launch counter rose by the expected count, traces one more
   batch with ``torch.profiler``, and checks the card's result against the
   CPU's plain path on a small input.
4. Prints one ``{"kernels": [...]}`` line, the card's name and power limit,
   and, as the last line, ``{"ok": true, "device": {...}}``.

Any failed phase raises and exits non-zero, with no result line. Details
(compiler logs, per-call timings) go to ``chiprun_out/chip_smoke.json``, and
the traced batch's device time by kernel and idle share to
``chiprun_out/detect_profile.txt``.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNELS = ("gaussian_mmv", "stem_pool", "roi_align")
# per batch on the main path
EXPECTED_LAUNCHES = {"gaussian_mmv": 3, "stem_pool": 1, "roi_align": 2}
# NVIDIA H100 SXM data sheet, dense: fp32 on CUDA cores, bf16 on tensor cores
# (fp32 accumulate), HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# flagship on-line widths (OnlineTrainConfig of the JAX package's online pipeline)
N_CLASSES, N_ANCHORS = 21, 15
RPN_M, RPN_SIGMA, DET_M, DET_SIGMA, MASK_M, MASK_SIGMA = 1000, 50.0, 1000, 15.0, 500, 10.0
CANVAS = (608, 800)
BATCHES, BATCH_SIZE = 3, 8


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


def add_call(rec, call):
    """Adds one call's times to its kernel's totals; the kernel's bound is the
    sum of its calls' bounds, bounded by what bounds their sum."""
    rec["calls"].append(call)
    for k in ("ms", "plain_ms", "bound_ms", "flops", "bytes"):
        rec[k] = rec.get(k, 0.0) + call[k]
    rec["bound_by"] = bound_of(rec["flops"], rec["bytes"])[1]


def torch_isfinite(t) -> bool:
    import torch

    return bool(torch.isfinite(t.float()).all())


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


def check_mmv(inputs, report):
    from online_detection_tpu_torch.ops.gaussian_mmv import mmv_grouped, mmv_reference

    rec = report.setdefault("gaussian_mmv", {"calls": []})
    for role, x, fm, set_idx in inputs["mmv"]:
        v = fm.alpha
        got = mmv_grouped(x, fm.centers, v, fm.sigma, set_idx)
        ref = mmv_reference(x, fm.centers, v, fm.sigma, set_idx)
        # 1e-5 of the sum of the terms' magnitudes (K >= 0, so that is K @ |v|)
        terms = mmv_reference(x, fm.centers, v.abs(), fm.sigma, set_idx)
        check_close("gaussian_mmv", got, ref, 1e-5 * terms + 1e-30, report)
        ms = timed(lambda: mmv_grouped(x, fm.centers, v, fm.sigma, set_idx))
        plain = timed(lambda: mmv_reference(x, fm.centers, v, fm.sigma, set_idx), 3)
        g = fm.centers.shape[0] if set_idx is None else set_idx.shape[0]
        n, d = x.shape[-2], x.shape[-1]
        m = fm.centers.shape[1]
        flops = 2.0 * g * n * m * (d + 1)
        nbytes = 4.0 * (x.numel() + fm.centers.numel() + v.numel() + g * n)
        bound, by = bound_of(flops, nbytes)
        add_call(rec, {"role": role, "groups": g, "rows": n, "centers": m, "d": d,
                       "ms": ms, "plain_ms": plain, "bound_ms": bound, "flops": flops,
                       "bytes": nbytes,
                       "max_rel_to_terms": float(((got - ref).abs() / terms).max())})
        print(f"  gaussian_mmv[{role}] G={g} N={n} M={m} d={d}: {ms:.3f} ms "
              f"(plain {plain:.3f} ms, bound {bound:.3f} ms, {by})", flush=True)
    rec["tolerance"] = "1e-5 of sum |terms| (fp32)"


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
    ms = timed(lambda: stem_fused(x, *args), 10)
    plain = timed(lambda: stem_reference(x, *args), 3)
    b, h, w, _ = x.shape
    h2, w2 = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    flops = 2.0 * b * h2 * w2 * 64 * 147
    nbytes = 2.0 * (x.numel() + got.numel()) + 4.0 * (p.weight.numel() + 128)
    # a bf16 conv with fp32 accumulation is an implicit GEMM (K = 7*7*3 = 147)
    # that the tensor cores run: its bound is at their bf16 rate
    bound, by = bound_of(flops, nbytes, PEAK_BF16_FLOPS)
    report["stem_pool"].update(
        ms=ms, plain_ms=plain, bound_ms=bound, flops=flops, bytes=nbytes, bound_by=by,
        tolerance="bf16: 1 ulp + 1e-5 max|ref|; f32: 1e-5 max|ref|", shape=list(x.shape))
    print(f"  stem_pool {list(x.shape)} bf16: {ms:.3f} ms (plain {plain:.3f} ms, "
          f"bound {bound:.3f} ms, {by})", flush=True)


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
                       "bound_ms": bound, "flops": flops, "bytes": nbytes})
        print(f"  roi_align[{role}] {list(got.shape)} bf16: {ms:.3f} ms (plain {plain:.3f} ms, "
              f"bound {bound:.3f} ms, {by})", flush=True)
    rec["tolerance"] = "bf16: 1 ulp + 1e-5 max|ref|; f32: 1e-5 max|ref|"


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
              for k in ("mmv_grouped_kernel", "stem_kernel", "roi_align_kernel")}
    summary = {"card": card, "wall_ms": wall_us / 1e3, "kernel_ms": device_us / 1e3,
               "busy_ms": busy / 1e3, "idle_share": 1.0 - busy / wall_us if wall_us else None,
               "port_kernels_ms": {k: v / 1e3 for k, v in groups.items()},
               "n_kernel_launches": len(kernels)}
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    lines = [json.dumps(summary), f"{'ms':>10} {'calls':>6}  kernel"]
    lines += [f"{us / 1e3:10.3f} {n:6d}  {name[:150]}" for name, (us, n) in rows]
    out_path.write_text("\n".join(lines) + "\n")
    return summary


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
        check_roi(inputs, report)
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
    for k, per in EXPECTED_LAUNCHES.items():
        if launches[k] != per * BATCHES:
            fail(f"{k} launched {launches[k]} times on the main path, "
                 f"expected {per * BATCHES}")
    print(f"detect_batched {b}x{h}x{w}: ms/batch {[round(t, 3) for t in times]} "
          f"valid detections {n_valid} launches {launches} on {card}", flush=True)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    profiled = profile_batch(
        lambda: detect_batched(params, online, anchors, batches[0], sizes, cfg, True),
        out_dir / "detect_profile.txt", card)
    print(f"profile of one batch: {json.dumps(profiled)}", flush=True)

    small_reference_check(params, online, dev, report)

    replaces = {
        "gaussian_mmv": "online_detection_tpu/ops/gaussian_mmv.py:219",
        "stem_pool": "online_detection_tpu/ops/stem_pool.py:150",
        "roi_align": "online_detection_tpu/ops/roi_align.py:175",
    }
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": f"online_detection_tpu_torch/csrc/{k}.cu",
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": report[k]["max_abs_err"], "ms": report[k]["ms"],
         "plain_ms": report[k]["plain_ms"], "bound_ms": report[k]["bound_ms"],
         "bound_by": report[k]["bound_by"], "library_ms": None}
        for k in KERNELS],
        "not_ported": [{"name": "roi_align_fused2",
                        "replaces": "online_detection_tpu/ops/roi_align.py:311"}]}
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": report, "ms_per_batch": times, "launches": launches,
         "valid_detections": n_valid, "profile": profiled, "build_logs": logs,
         "seconds": time.time() - t_start}, indent=1))
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
