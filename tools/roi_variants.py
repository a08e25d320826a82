#!/usr/bin/env python3
"""Where the RoIAlign kernels B3 and B4 (``online_detection_tpu_torch/csrc/
roi_align.cu`` and ``roi_align_fused2.cu``, one body in
``roi_align_common.cuh``) spend their time on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/roi_variants.py [--seed 0]

1. Builds the kernels as they are, variants made by editing the shared
   body, and the two kernels these replaced (their sources are kept at the
   end of this file). Variants that drop one piece of work (their outputs are wrong;
   only their times mean something):

   - ``no_load``: no feature is loaded (every tap reads a constant);
   - ``no_store``: no output is written;
   - ``store_only``: nothing is loaded or contracted: zeros are written;
   - ``one_sample``: one sample per bin and axis;
   - ``default_cache``: the feature loads and the output stores without
     the L2 evict-last / evict-first policies (this one is still right);

   and other layouts the body could take (outputs checked):

   - ``no_pair``: every bin reads its columns from the shared-memory ring
     (no pair of columns kept in registers);
   - ``chunk_2``: columns contracted 2 at a time (their loads in flight
     together), not 4;
   - ``warps_2``: 2 warps a block (registers capped for 10 blocks an SM),
     not 4 (capped for 5).
2. Builds ``chip_smoke.py``'s inputs from the seed (the R-50-C4 trunk with
   random weights; the 300 proposals and the first 100 of them of 8
   synthetic 608x800 canvases; the 20 GT ++ 300 proposals of the first
   batch of the 64 synthetic teaching images) and times every library
   through the port's wrappers at the four main-path calls: inference
   proposals and detections (B3), harvest (B4), and serving (B3 on the
   teaching canvases' 300 proposals; the serving batch's own proposals come
   from the trained on-line RPN, which this tool does not train).
3. Per call: the RoIs' mean samples per bin and axis, and the bytes they
   must read from L2 at the least (each feature element a RoI touches, once
   per RoI) beside the bytes they write; the bound is ``chip_smoke.py``'s.
``ncu`` does not run on the card's machine ("Failed to initialize the
profiler: LibraryNotLoaded"), so the tool has no L2 or DRAM byte counts.

Prints one line per call and writes ``chiprun_out/roi_variants.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HEADER = "roi_align_common.cuh"
SOURCES = {"roi_align": "roi_align.cu", "roi_align_fused2": "roi_align_fused2.cu"}

# variant -> (text in the shared body, its replacement), applied in turn
VARIANTS = {
    "kernel": [],
    "no_load": [("r0[k] = load16(f0 + (size_t)k * C, pol_last);",
                 "r0[k] = make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, k);"),
                ("if (two) r1[k] = load16(f0 + (size_t)(W + k) * C, pol_last);",
                 "if (two) r1[k] = make_uint4(0x3f803f80u, 0x3f803f80u, k, 0x3f803f80u);")],
    "no_store": [(
        "if (live) store16(orow + (size_t)q * C, pack(acc), pol_first);",
        "const uint4 o4 = pack(acc);\n"
        "      if (live && o4.x == 0x7fc00001u && o4.y == o4.z) "
        "store16(orow + (size_t)q * C, o4, pol_first);")],
    "one_sample": [("n = fminf(fmaxf(ceilf(bin), 1.f), (float)MAX_SAMPLES);", "n = 1.f;")],
    "default_cache": [
        ("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;",
         "ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"),
        ("st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;",
         "st.global.v4.b32 [%0], {%1, %2, %3, %4};")],
    "store_only": [
        ("      if (qb - qa < RING && qa + RING >= next) {",
         "      if (false && qb - qa < RING && qa + RING >= next) {"),
        ("        for (int x = qa; x <= qb; ++x) {\n          columns(x, 1);",
         "        for (int x = qa; x < qa; ++x) {\n          columns(x, 1);")],
    "no_pair": [("if (qb - qa <= 1) {  // bins narrower", "if (false) {  // bins narrower")],
    "chunk_2": [("constexpr int CH = 4;", "constexpr int CH = 2;")],
    "warps_2": [("constexpr int WARPS = 4;", "constexpr int WARPS = 2;"),
                ("constexpr int MIN_BLOCKS = 5;", "constexpr int MIN_BLOCKS = 10;")],
}
# libraries whose outputs are held against the plain version
CHECKED = ("kernel", "default_cache", "no_pair", "chunk_2", "warps_2", "replaced")


def build_all(_build):
    """One pair of libraries (B3, B4) per variant and for the replaced kernels,
    nvcc in parallel, under the build directory."""
    header = (_build.CSRC / HEADER).read_text()
    base = _build.BUILD_DIR / "roi_variants"
    dirs = {}
    for name, edits in VARIANTS.items():
        text = header
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"roi_variants: {name}: the kernel source has changed")
            text = text.replace(old, new)
        d = base / name
        d.mkdir(parents=True, exist_ok=True)
        (d / HEADER).write_text(text)
        for src in SOURCES.values():
            shutil.copy(_build.CSRC / src, d / src)
        dirs[name] = d
    d = base / "replaced"
    d.mkdir(parents=True, exist_ok=True)
    (d / SOURCES["roi_align"]).write_text(REPLACED_B3)
    (d / SOURCES["roi_align_fused2"]).write_text(REPLACED_B4)
    dirs["replaced"] = d
    procs = {}
    for name, d in dirs.items():
        for kernel, src in SOURCES.items():
            so = d / f"lib{kernel}.so"
            procs[name, kernel] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(d / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, logs = {}, {}
    for (name, kernel), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"roi_variants: nvcc failed for {name}/{kernel}:\n{log}")
        libs.setdefault(name, {})[kernel] = ctypes.CDLL(str(so))
        logs[f"{name}/{kernel}"] = [ln.strip() for ln in log.splitlines()
                                    if "registers" in ln or "spill" in ln]
    return libs, logs


@contextlib.contextmanager
def library(_build, pair):
    """The port's RoIAlign wrappers launch from ``pair`` inside the block."""
    saved = {k: _build._LIBS.get(k) for k in SOURCES}
    _build._LIBS.update(pair)
    try:
        yield
    finally:
        _build._LIBS.update(saved)


def timed(fn, iters=10):
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


def spans(rois, h, w, pooled=14, scale=1.0 / 16.0):
    """Per RoI: samples per bin on each axis, and the rows x columns of the
    feature map its taps touch (first to last tap)."""
    import torch

    r = rois.reshape(-1, 4).float()

    def axis(lo, hi, dim):
        start = lo * scale
        bin_ = torch.clamp(hi * scale - start, min=1.0) / pooled
        n = torch.clamp(torch.ceil(bin_), 1, 8)
        first = torch.clamp(start + 0.5 / n * bin_, 0, dim - 1).floor()
        last_c = torch.clamp(start + (pooled - 1 + (n - 0.5) / n) * bin_, 0, dim - 1)
        last = torch.clamp(last_c.floor() + 1, max=dim - 1)
        return n, last - first + 1

    n_h, rows = axis(r[:, 1], r[:, 3], h)
    n_w, cols = axis(r[:, 0], r[:, 2], w)
    return n_h, n_w, rows * cols


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("roi_variants: this probe needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from online_detection_tpu_torch.models.anchors import grid_anchors
    from online_detection_tpu_torch.models.detector import DetectorConfig, init_detector_params
    from online_detection_tpu_torch.ops import _build
    from online_detection_tpu_torch.ops.roi_align import (
        roi_align_batched, roi_align_fused2, roi_align_fused2_reference, roi_align_reference)
    from online_detection_tpu_torch.utils.device import ieee_fp32

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    _build.build_all(cs.KERNELS)
    libs, logs = build_all(_build)
    for k, lines in logs.items():
        if k.startswith("kernel/") or k.startswith("replaced/"):
            print(f"  {k}: {lines}", flush=True)

    # chip_smoke.py's inputs, drawn in its order from the same seed
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    b, (h, w) = cs.BATCH_SIZE, cs.CANVAS
    params = init_detector_params(args.seed, cs.N_ANCHORS, cs.N_CLASSES + 1).to(dev)
    cfg = DetectorConfig()
    anchors = torch.from_numpy(grid_anchors(h // 16, w // 16)).to(dev)
    sizes = torch.tensor([[w, h]] * b, dtype=torch.float32, device=dev)
    images = torch.from_numpy(rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8)).to(dev)
    with torch.inference_mode(), ieee_fp32():
        _, inputs = cs.build_online(rng, params, images, sizes, anchors, cfg, dev)
        ds = cs.SyntheticTeachingSet(cs.TRAIN_IMAGES, cs.TRAIN_HW, cs.N_CLASSES, args.seed)
        hc4, hrois = cs.harvest_inputs(params, ds, cfg, dev)
    c4 = inputs["c4"]
    calls = [("proposals", "roi_align", c4, inputs["props"]),
             ("detections", "roi_align", c4, inputs["dets"]),
             ("harvest", "roi_align_fused2", hc4, hrois),
             ("serving", "roi_align", hc4, hrois[:, 20:].contiguous())]
    entry = {"roi_align": (roi_align_batched, roi_align_reference),
             "roi_align_fused2": (roi_align_fused2, roi_align_fused2_reference)}

    report = {"card": card, "build": logs, "calls": {}}
    with torch.inference_mode():
        for role, kernel, feats, rois in calls:
            fn, plain = entry[kernel]
            ref = plain(feats, rois)
            tol = cs.bf16_ulp(ref.float()) + 1e-5 * ref.float().abs().max()
            _, fh, fw, c = feats.shape
            n_h, n_w, touched = spans(rois, fh, fw)
            out_bytes = 2.0 * ref.numel()
            flops = cs.roi_ops(rois, fh, fw, c)
            nbytes = 2.0 * (feats.numel() + ref.numel()) + 4.0 * rois.numel()
            bound, by = cs.bound_of(flops, nbytes)
            row = {"kernel": kernel, "shape": list(ref.shape), "bound_ms": bound, "bound_by": by,
                   "n_h_mean": float(n_h.mean()), "n_w_mean": float(n_w.mean()),
                   "n_max": float(torch.maximum(n_h, n_w).max()),
                   "touched_bytes": float(touched.sum()) * c * 2.0, "out_bytes": out_bytes,
                   "times_ms": {}, "max_err": {}}
            for name, pair in libs.items():
                with library(_build, pair):
                    if name in CHECKED:
                        got = fn(feats, rois)
                        err = (got.float() - ref.float()).abs()
                        row["max_err"][name] = float(err.max())
                        if bool((err > tol).any()):
                            raise SystemExit(f"roi_variants: {name} disagrees with the plain "
                                             f"version at {role} (max err {float(err.max())})")
                        del got, err
                    row["times_ms"][name] = timed(lambda: fn(feats, rois))
            report["calls"][role] = row
            print(f"{role:10s} {kernel:16s} {row['shape']} n_h {row['n_h_mean']:.2f} n_w "
                  f"{row['n_w_mean']:.2f} touched/out bytes "
                  f"{row['touched_bytes'] / out_bytes:.2f} bound {bound:.3f} ({by}) | "
                  + " | ".join(f"{k} {t:.3f}" for k, t in row["times_ms"].items()), flush=True)
            del ref, tol

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "roi_variants.json").write_text(json.dumps(report, indent=1))
    return 0


# ---------------------------------------------------------------------------
# The kernels these replaced, as they were (comments dropped): B3 sampled each bin
# directly, B4 contracted H first per pooled row. Same C entry points.

REPLACED_B3 = r'''#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_SAMPLES = 8;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Axis {
  int n;                       // samples in use
  int lo[MAX_SAMPLES];
  int hi[MAX_SAMPLES];
  float wlo[MAX_SAMPLES];      // 0 for a sample outside [-1, dim]
  float whi[MAX_SAMPLES];
};

__device__ __forceinline__ void axis_samples(float start, float size, int pooled, int p,
                                             int dim, Axis& a) {
  const float bin = size / (float)pooled;
  const float n = fminf(fmaxf(ceilf(bin), 1.f), (float)MAX_SAMPLES);
  a.n = (int)n;
  for (int s = 0; s < MAX_SAMPLES; ++s) {
    if (s >= a.n) break;
    const float coord = start + ((float)p + ((float)s + 0.5f) / n) * bin;
    const bool in_range = coord >= -1.f && coord <= (float)dim;
    const float c = fminf(fmaxf(coord, 0.f), (float)dim - 1.f);
    const float low = floorf(c);
    const float frac = c - low;
    a.lo[s] = (int)low;
    a.hi[s] = min((int)low + 1, dim - 1);
    a.wlo[s] = in_range ? 1.f - frac : 0.f;
    a.whi[s] = in_range ? frac : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
roi_align_kernel(const T* __restrict__ feats, const float* __restrict__ rois,
                 T* __restrict__ out, int r_per_img, int h, int w, int c, int pooled,
                 float spatial_scale) {
  const int roi = blockIdx.x;  // b * R + r
  const int ph = blockIdx.y;
  const int b = roi / r_per_img;
  const float* box = rois + (long long)roi * 4;
  const float x1 = box[0] * spatial_scale, y1 = box[1] * spatial_scale;
  const float x2 = box[2] * spatial_scale, y2 = box[3] * spatial_scale;
  const float size_w = fmaxf(x2 - x1, 1.f);
  const float size_h = fmaxf(y2 - y1, 1.f);

  Axis ay;
  axis_samples(y1, size_h, pooled, ph, h, ay);
  const T* fb = feats + (long long)b * h * w * c;

  for (int pw = 0; pw < pooled; ++pw) {
    Axis ax;
    axis_samples(x1, size_w, pooled, pw, w, ax);
    const float inv = 1.f / (float)(ay.n * ax.n);
    T* ob = out + (((long long)roi * pooled + ph) * pooled + pw) * c;
    for (int ch = threadIdx.x; ch < c; ch += THREADS) {
      float acc = 0.f;
      for (int sy = 0; sy < ay.n; ++sy) {
        const T* rlo = fb + (long long)ay.lo[sy] * w * c + ch;
        const T* rhi = fb + (long long)ay.hi[sy] * w * c + ch;
        for (int sx = 0; sx < ax.n; ++sx) {
          const long long ol = (long long)ax.lo[sx] * c, oh = (long long)ax.hi[sx] * c;
          const float top = ax.wlo[sx] * to_f32(rlo[ol]) + ax.whi[sx] * to_f32(rlo[oh]);
          const float bot = ax.wlo[sx] * to_f32(rhi[ol]) + ax.whi[sx] * to_f32(rhi[oh]);
          acc += ay.wlo[sy] * top + ay.whi[sy] * bot;
        }
      }
      ob[ch] = from_f32<T>(acc * inv);
    }
  }
}

template <typename T>
int launch(const void* feats, const void* rois, void* out, int b, int r, int h, int w,
           int c, int pooled, float scale, void* stream) {
  dim3 grid(b * r, pooled);
  roi_align_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)feats, (const float*)rois, (T*)out, r, h, w, c, pooled, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int odt_roi_align(const void* feats, const void* rois, void* out, int b, int r,
                             int h, int w, int c, int pooled, float spatial_scale,
                             int dtype, void* stream) {
  if (b * r == 0) return 0;
  if (dtype == 0)
    return launch<float>(feats, rois, out, b, r, h, w, c, pooled, spatial_scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feats, rois, out, b, r, h, w, c, pooled, spatial_scale,
                                 stream);
  return (int)cudaErrorInvalidValue;
}
'''

REPLACED_B4 = r'''#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_SAMPLES = 8;
constexpr int MAX_POOLED = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CT = 64;  // channels per block: 32 lanes x 2
constexpr int MAX_SLICE_BYTES = 48 * 1024;  // dynamic shared memory without opt-in

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

__device__ __forceinline__ void tabulate(float start, float bin, float n, int p, int s, int dim,
                                         int* lo, int* hi, float* wlo, float* whi) {
  const float coord = start + ((float)p + ((float)s + 0.5f) / n) * bin;
  const bool in_range = coord >= -1.f && coord <= (float)dim;
  const float c = fminf(fmaxf(coord, 0.f), (float)dim - 1.f);
  const float low = floorf(c);
  const float frac = c - low;
  *lo = (int)low;
  *hi = min((int)low + 1, dim - 1);
  *wlo = in_range ? 1.f - frac : 0.f;
  *whi = in_range ? frac : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
roi_align_fused2_kernel(const T* __restrict__ feats, const float* __restrict__ rois,
                        T* __restrict__ out, int r_per_img, int h, int w, int c, int pooled,
                        float spatial_scale) {
  extern __shared__ float slice[];  // [w1 - w0 + 1][CT]: stage 1 of one pooled row
  __shared__ int ylo[MAX_POOLED * MAX_SAMPLES], yhi[MAX_POOLED * MAX_SAMPLES];
  __shared__ int xlo[MAX_POOLED * MAX_SAMPLES], xhi[MAX_POOLED * MAX_SAMPLES];
  __shared__ float ywl[MAX_POOLED * MAX_SAMPLES], ywh[MAX_POOLED * MAX_SAMPLES];
  __shared__ float xwl[MAX_POOLED * MAX_SAMPLES], xwh[MAX_POOLED * MAX_SAMPLES];

  const int roi = blockIdx.x;  // b * R + r
  const int b = roi / r_per_img;
  const float* box = rois + (long long)roi * 4;
  const float x1 = box[0] * spatial_scale, y1 = box[1] * spatial_scale;
  const float size_w = fmaxf(box[2] * spatial_scale - x1, 1.f);
  const float size_h = fmaxf(box[3] * spatial_scale - y1, 1.f);
  const float bin_w = size_w / (float)pooled, bin_h = size_h / (float)pooled;
  const float fnw = fminf(fmaxf(ceilf(bin_w), 1.f), (float)MAX_SAMPLES);
  const float fnh = fminf(fmaxf(ceilf(bin_h), 1.f), (float)MAX_SAMPLES);
  const int nw = (int)fnw, nh = (int)fnh;

  for (int i = threadIdx.x; i < pooled * nh; i += THREADS)
    tabulate(y1, bin_h, fnh, i / nh, i % nh, h, &ylo[i], &yhi[i], &ywl[i], &ywh[i]);
  for (int i = threadIdx.x; i < pooled * nw; i += THREADS)
    tabulate(x1, bin_w, fnw, i / nw, i % nw, w, &xlo[i], &xhi[i], &xwl[i], &xwh[i]);
  __syncthreads();

  const int w0 = xlo[0];
  const int w1 = xhi[pooled * nw - 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ch = blockIdx.y * CT + 2 * lane;
  const bool live = ch < c;  // c is even, so ch + 1 < c too
  const float inv = 1.f / (fnh * fnw);
  const T* fb = feats + (long long)b * h * w * c + ch;
  float* srow = slice + 2 * lane;

  for (int p = 0; p < pooled; ++p) {
    for (int x = w0 + warp; x <= w1; x += WARPS) {
      float2 acc = make_float2(0.f, 0.f);
      if (live) {
        for (int s = 0; s < nh; ++s) {
          const int i = p * nh + s;
          const float2 lo = load2(fb + ((long long)ylo[i] * w + x) * c);
          const float2 hi = load2(fb + ((long long)yhi[i] * w + x) * c);
          acc.x += ywl[i] * lo.x + ywh[i] * hi.x;
          acc.y += ywl[i] * lo.y + ywh[i] * hi.y;
        }
      }
      store2(srow + (x - w0) * CT, acc);
    }
    __syncthreads();
    for (int q = warp; q < pooled; q += WARPS) {
      float2 acc = make_float2(0.f, 0.f);
      for (int s = 0; s < nw; ++s) {
        const int i = q * nw + s;
        const float2 lo = load2(srow + (xlo[i] - w0) * CT);
        const float2 hi = load2(srow + (xhi[i] - w0) * CT);
        acc.x += xwl[i] * lo.x + xwh[i] * hi.x;
        acc.y += xwl[i] * lo.y + xwh[i] * hi.y;
      }
      if (live)
        store2(out + (((long long)roi * pooled + p) * pooled + q) * c + ch,
               make_float2(acc.x * inv, acc.y * inv));
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* feats, const void* rois, void* out, int b, int r, int h, int w, int c,
           int pooled, float scale, void* stream) {
  const dim3 grid(b * r, (c + CT - 1) / CT);
  const size_t smem = (size_t)w * CT * sizeof(float);
  roi_align_fused2_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)feats, (const float*)rois, (T*)out, r, h, w, c, pooled, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int odt_roi_align_fused2(const void* feats, const void* rois, void* out, int b,
                                    int r, int h, int w, int c, int pooled,
                                    float spatial_scale, int dtype, void* stream) {
  if (b * r == 0) return 0;
  if (pooled < 1 || pooled > MAX_POOLED || c < 2 || c % 2 != 0 || h < 1 || w < 1 ||
      w > MAX_SLICE_BYTES / (CT * (int)sizeof(float)) || (c + CT - 1) / CT > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(feats, rois, out, b, r, h, w, c, pooled, spatial_scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feats, rois, out, b, r, h, w, c, pooled, spatial_scale,
                                 stream);
  return (int)cudaErrorInvalidValue;
}
'''


if __name__ == "__main__":
    sys.exit(main())
