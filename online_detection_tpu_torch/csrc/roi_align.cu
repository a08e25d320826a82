// Batched RoIAlign on Hopper (kernel B3), legacy-Detectron semantics, NHWC.
//
// Replaces: online_detection_tpu/ops/roi_align.py::roi_align_batched (body
// _fused_pool_kernel). features [B, H, W, C] x rois [B, R, 4] (xyxy, image
// coordinates) -> [B, R, P, P, C] in the features' dtype. The inference
// path calls it twice a batch: 300 proposals, then 100 detections, of a
// [8, 38, 50, 1024] bf16 map.
//
// What bounds it on an H100: the output. A call writes 0.96 GB (proposals)
// or 0.32 GB (detections) of bf16, 0.29 / 0.10 ms at 3.35 TB/s, while the
// feature map (31 MB) sits in the 50 MB L2. The proposals are small: one
// sample per bin and axis on average (1.01), and the feature bytes they
// touch are 0.44 of those they write.
//
// Design: the body in roi_align_common.cuh, shared with B4: a warp per
// (pooled row, 256-channel tile), H contracted into a lane-private ring of
// columns with the loads of 4 columns in flight together, W from the ring
// or from two registers, 16-byte loads and stores, evict-first output,
// registers capped for 5 blocks an SM. The kernel this replaces sampled
// each bin directly with scalar bf16 taps and its sample tables in local memory.
//
// Measured (tools/roi_variants.py, NVIDIA H100 80GB HBM3, 700 W; proposals /
// detections call, ms): 0.477 / 0.191, the replaced kernel 2.030 / 0.767, bound
// 0.297 / 0.105. Writing zeros alone, with no load and no arithmetic, takes
// 0.312 / 0.110; without the feature loads 0.378 / 0.140.
//
// Tried on the card and not kept (same tool and card; the first four in
// earlier runs, before the ring's bank conflicts were removed):
// - W first, feature rows staged by cp.async in a 4-slot ring, a thread per
//   (pooled column, channel vector) with 7 pooled rows of accumulators:
//   1.322 / 0.543; one barrier per staged row, 128 registers, and dropping
//   the loads or the stores changed nothing;
// - the kept order with one column at a time: 0.710 / 0.345, two serial L2
//   latencies per column (without feature loads: 0.487);
// - 4 columns at a time at 105 to 147 registers (3-4 blocks an SM): 0.587
//   to 0.616; registers capped for 6 blocks: 0.531 (2 columns at a time) to
//   0.722 (4 columns, spilling); for 7 (a 4-column ring, spilling): 0.545;
// - each lane's 32 bytes of a ring slot contiguous, so that a warp's 16-byte
//   accesses conflict two ways: 0.524 / 0.207;
// - every bin from the ring, no register pair: 0.526 / 0.201; 2 columns at
//   a time: 0.492 / 0.202; 2 channel tiles a block: 0.459 / 0.206; 2 warps
//   a block: 0.460 / 0.210; no L2 policies: 0.492 / 0.197.

#include "roi_align_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(roi::THREADS, roi::MIN_BLOCKS) roi_align_kernel(roi::Args a) {
  roi::pool_rows<T>(a);
}

unsigned long long opted[2];  // per dtype, a bit a device: the opt-in is set

}  // namespace

// feats: [b, h, w, c] float32 (dtype 0) or bfloat16 (dtype 1), c a multiple
// of 16 bytes, 16-byte aligned; rois: [b, r, 4] fp32; out: [b, r, pooled,
// pooled, c] in feats' dtype, 16-byte aligned.
extern "C" int odt_roi_align(const void* feats, const void* rois, void* out, int b, int r,
                             int h, int w, int c, int pooled, float spatial_scale,
                             int dtype, void* stream) {
  if (b * r == 0) return 0;
  const roi::Args a{feats, (const float*)rois, out, r, h, w, c, pooled, spatial_scale};
  if (dtype == 0)
    return roi::launch(roi_align_kernel<float>, a, b, r, 4, stream, &opted[0]);
  if (dtype == 1)
    return roi::launch(roi_align_kernel<__nv_bfloat16>, a, b, r, 8, stream, &opted[1]);
  return (int)cudaErrorInvalidValue;
}
