// RoIAlign of the harvest pass on Hopper (kernel B4), legacy-Detectron
// semantics, NHWC.
//
// Replaces: online_detection_tpu/ops/roi_align.py::roi_align_fused2 (body
// _fused2_kernel). features [B, H, W, C] x rois [B, R, 4] (xyxy, image
// coordinates) -> [B, R, P, P, C] in the features' dtype. The harvest pools
// GT ++ proposal boxes through it: 20 + 300 RoIs of a [8, 38, 50, 1024]
// bf16 map, once a batch. The TPU kernel computes A @ F @ B^T as two MXU
// matmuls, the second block-diagonal over a tile of RoIs with an (8, 128)
// regroup between them; both exist only for the MXU and are not carried
// over.
//
// What bounds it on an H100: the output, 1.03 GB of bf16 a call (0.31 ms
// at 3.35 TB/s), while the feature map (31 MB) sits in the 50 MB L2. Most
// RoIs are proposals with one sample per bin; the GT boxes are larger (1.12
// samples per bin down, 1.33 across on average), and the feature bytes all
// RoIs touch are 0.42 of those they write.
//
// Design: the body in roi_align_common.cuh, shared with B3 (the function is
// the same; the harvest favours the same order): a warp per (pooled row,
// 256-channel tile), H contracted into a lane-private ring of columns with
// the loads of 4 columns in flight together, W from the ring or from two
// registers, 16-byte loads and stores, evict-first output, registers capped
// for 5 blocks an SM. The kernel this replaces contracted H per pooled row
// into a shared slice with 4-byte accesses and two barriers per pooled row.
//
// Measured (tools/roi_variants.py, NVIDIA H100 80GB HBM3, 700 W; the harvest
// call, ms): 0.531, the replaced kernel 1.631, bound 0.316. Writing zeros alone
// takes 0.334; without the feature loads 0.405.
//
// Tried on the card and not kept (same tool and card; the first four in
// earlier runs, before the ring's bank conflicts were removed):
// - W first, feature rows staged by cp.async in a 4-slot ring, a thread per
//   (pooled column, channel vector) with 7 pooled rows of accumulators:
//   1.295;
// - the kept order with one column at a time: 0.896 (without feature
//   loads: 0.524);
// - 4 columns at a time at 105 to 147 registers (3-4 blocks an SM): 0.656
//   to 0.686; registers capped for 6 blocks: 0.633 (2 columns at a time) to
//   0.785 (4 columns, spilling);
// - each lane's 32 bytes of a ring slot contiguous (two-way bank
//   conflicts): 0.574;
// - no register pair: 0.565; 2 columns at a time: 0.541; 2 channel tiles a
//   block: 0.549; 2 warps a block: 0.570; no L2 policies: 0.544.

#include "roi_align_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(roi::THREADS, roi::MIN_BLOCKS)
    roi_align_fused2_kernel(roi::Args a) {
  roi::pool_rows<T>(a);
}

unsigned long long opted[2];  // per dtype, a bit a device: the opt-in is set

}  // namespace

// feats: [b, h, w, c] float32 (dtype 0) or bfloat16 (dtype 1), c a multiple
// of 16 bytes, 16-byte aligned; rois: [b, r, 4] fp32; out: [b, r, pooled,
// pooled, c] in feats' dtype, 16-byte aligned.
extern "C" int odt_roi_align_fused2(const void* feats, const void* rois, void* out, int b,
                                    int r, int h, int w, int c, int pooled,
                                    float spatial_scale, int dtype, void* stream) {
  if (b * r == 0) return 0;
  const roi::Args a{feats, (const float*)rois, out, r, h, w, c, pooled, spatial_scale};
  if (dtype == 0)
    return roi::launch(roi_align_fused2_kernel<float>, a, b, r, 4, stream, &opted[0]);
  if (dtype == 1)
    return roi::launch(roi_align_fused2_kernel<__nv_bfloat16>, a, b, r, 8, stream,
                       &opted[1]);
  return (int)cudaErrorInvalidValue;
}
