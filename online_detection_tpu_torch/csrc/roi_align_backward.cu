// RoIAlign backward on Hopper: the gradient of kernel B3 in the features,
// legacy-Detectron semantics, NHWC, float32.
//
// Backward of: online_detection_tpu/ops/roi_align.py::roi_align (the
// function the JAX trainer differentiates with jax.grad; the TPU kernel
// roi_align_batched computes the same forward). grad g [B, R, P, P, C] x rois
// [B, R, 4] (xyxy, image coordinates) -> dF [B, H, W, C]:
//
//   dF[h, w, c] = sum_r sum_{p, q} A_r[p, h] B_r[q, w] g[r, p, q, c]
//
// with A_r, B_r the forward's averaged-bilinear interpolation matrices, built
// by the same device code (roi::Axis in roi_align_common.cuh), so the forward
// and the backward cannot disagree on a sample or a weight. The caller zeroes
// dF first.
//
// What bounds it on an H100: the bytes of g. A training step's call reads
// 512 x 14 x 14 x 1024 f32 (411 MB) and writes a 38 x 50 x 1024 map (7.8 MB):
// 0.125 ms at 3.35 TB/s. The atomics add a read-modify-write in L2 for each
// (RoI, feature cell the RoI touches, channel vector).
//
// Design (simple first). A block takes one RoI and one channel tile of 32
// lanes x 4 floats; it tabulates the RoI's A and B densely in shared memory
// over the rows and columns the RoI touches, as the forward does. Each warp
// then takes feature columns x of the RoI: it contracts q into T[p] =
// sum_q B[q, x] g[p, q, c] for every pooled row p (the bins q whose taps
// reach x, 16-byte loads of g), keeps T in a lane-private slice of shared
// memory, and then for each feature row y the RoI touches adds
// sum_p A[p, y] T[p] into dF[y, x, c] with one 16-byte atomicAdd. So each
// lane issues one atomic per touched cell, and a g vector is read once for
// each column its bin's taps reach (one or two for the small bins of most
// RoIs). Every control decision depends on (x, p, q, y) only, so it is
// uniform across the warp.
//
// The atomics' order changes from run to run, so dF's last bits do too.

#include "roi_align_common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

struct Args {
  const float* grad;
  const float* rois;
  float* out;
  int r_per_img, h, w, c, pooled;
  float scale;
  int tiles;  // channel tiles of 32 lanes x 4 floats: blocks per RoI
};

// float4 atomicAdd on global memory exists for sm_90 from CUDA 12.1 on
__device__ __forceinline__ void add4(float* dst, const float4& v) {
#if (__CUDACC_VER_MAJOR__ > 12) || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)
  atomicAdd(reinterpret_cast<float4*>(dst), v);
#else
  atomicAdd(dst, v.x);
  atomicAdd(dst + 1, v.y);
  atomicAdd(dst + 2, v.z);
  atomicAdd(dst + 3, v.w);
#endif
}

size_t smem_bytes(const Args& a) {
  return sizeof(float4) * WARPS * a.pooled * 32 + sizeof(float) * a.pooled * (a.h + a.w) +
         sizeof(int) * 4 * a.pooled;
}

__global__ void __launch_bounds__(THREADS) roi_align_backward_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int P = a.pooled, H = a.h, W = a.w, C = a.c;
  float4* tbuf = reinterpret_cast<float4*>(smem);             // [WARPS][P][32]
  float* ad = smem + 4 * WARPS * P * 32;                      // [P][H]: A over [ya, yb]
  float* bd = ad + P * H;                                     // [P][W]: B over [xa, xb]
  int* prange = reinterpret_cast<int*>(bd + P * W);           // [P][2], relative to ya
  int* qrange = prange + 2 * P;                               // [P][2], relative to xa

  const int roi = blockIdx.x / a.tiles;
  const int b = roi / a.r_per_img;
  const float* box = a.rois + (size_t)roi * 4;
  const roi::Axis ay(box[1], box[3], a.scale, P, H);
  const roi::Axis ax(box[0], box[2], a.scale, P, W);
  const int ya = ay.first(), xa = ax.first();
  const int hr = ay.last(P) - ya + 1, wr = ax.last(P) - xa + 1;

  const int tid = threadIdx.x;
  for (int i = tid; i < P * (H + W); i += THREADS) ad[i] = 0.f;  // bd follows ad
  __syncthreads();
  for (int i = tid; i < 2 * P; i += THREADS) {
    if (i < P)
      ay.fill(i, ya, ad + i * H, prange + 2 * i);
    else
      ax.fill(i - P, xa, bd + (i - P) * W, qrange + 2 * (i - P));
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int c = (blockIdx.x % a.tiles) * 128 + lane * 4;
  if (c >= C) return;  // no barrier follows
  const float* g = a.grad + (size_t)roi * P * P * C + c;     // g[roi, 0, 0, c]
  float* fout = a.out + ((size_t)(b * H + ya) * W + xa) * C + c;  // dF[b, ya, xa, c]
  float4* t = tbuf + (size_t)warp * P * 32 + lane;

  for (int x = warp; x < wr; x += WARPS) {
    // T[p] = sum over the bins q whose taps reach column x of B[q, x] g[p, q]
    for (int p = 0; p < P; ++p) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < P; ++q) {
        if (x < qrange[2 * q] || x > qrange[2 * q + 1]) continue;
        const float wx = bd[q * W + x];
        const float4 v = *reinterpret_cast<const float4*>(g + ((size_t)p * P + q) * C);
        acc.x = fmaf(wx, v.x, acc.x);
        acc.y = fmaf(wx, v.y, acc.y);
        acc.z = fmaf(wx, v.z, acc.z);
        acc.w = fmaf(wx, v.w, acc.w);
      }
      t[p * 32] = acc;
    }
    // dF[y, x] += sum over the rows p whose taps reach y of A[p, y] T[p]
    for (int y = 0; y < hr; ++y) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      bool any = false;
      for (int p = 0; p < P; ++p) {
        if (y < prange[2 * p] || y > prange[2 * p + 1]) continue;
        const float wy = ad[p * H + y];
        const float4 v = t[p * 32];
        acc.x = fmaf(wy, v.x, acc.x);
        acc.y = fmaf(wy, v.y, acc.y);
        acc.z = fmaf(wy, v.z, acc.z);
        acc.w = fmaf(wy, v.w, acc.w);
        any = true;
      }
      if (any) add4(fout + ((size_t)y * W + x) * C, acc);
    }
  }
}

bool opted = false;  // the large shared-memory opt-in is set

}  // namespace

// grad: [b, r, pooled, pooled, c] float32, c a multiple of 4, 16-byte aligned;
// rois: [b, r, 4] fp32; out: [b, h, w, c] float32, zeroed by the caller,
// 16-byte aligned.
extern "C" int odt_roi_align_backward(const void* grad, const void* rois, void* out, int b,
                                      int r, int h, int w, int c, int pooled,
                                      float spatial_scale, void* stream) {
  if (b * r == 0) return 0;
  if (pooled < 1 || pooled > roi::MAX_POOLED || h < 1 || w < 1 || h > roi::MAX_DIM ||
      w > roi::MAX_DIM || c < 4 || c % 4 != 0)
    return (int)cudaErrorInvalidValue;
  Args a{(const float*)grad, (const float*)rois, (float*)out, r, h, w, c, pooled,
         spatial_scale, (c / 4 + 31) / 32};
  if ((long long)b * r * a.tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (!opted) {  // once per process: allow more than 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        roi_align_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  roi_align_backward_kernel<<<(unsigned)(b * r * a.tiles), THREADS, smem_bytes(a),
                              (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
