// The RoIAlign backward kernel that csrc/roi_align_backward.cu replaced, as it
// was (comments dropped), kept to be timed beside it by chip_smoke.py and
// tools/roi_backward_variants.py. A block per (RoI, 128-channel tile); each
// warp takes feature columns and re-reads g from device memory for every
// column its bins' taps reach. Same C entry point, odt_roi_align_backward.
// Built with -I online_detection_tpu_torch/csrc (roi_align_common.cuh).

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
  int tiles;
};

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
  float4* tbuf = reinterpret_cast<float4*>(smem);
  float* ad = smem + 4 * WARPS * P * 32;
  float* bd = ad + P * H;
  int* prange = reinterpret_cast<int*>(bd + P * W);
  int* qrange = prange + 2 * P;

  const int roi = blockIdx.x / a.tiles;
  const int b = roi / a.r_per_img;
  const float* box = a.rois + (size_t)roi * 4;
  const roi::Axis ay(box[1], box[3], a.scale, P, H);
  const roi::Axis ax(box[0], box[2], a.scale, P, W);
  const int ya = ay.first(), xa = ax.first();
  const int hr = ay.last(P) - ya + 1, wr = ax.last(P) - xa + 1;

  const int tid = threadIdx.x;
  for (int i = tid; i < P * (H + W); i += THREADS) ad[i] = 0.f;
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
  if (c >= C) return;
  const float* g = a.grad + (size_t)roi * P * P * C + c;
  float* fout = a.out + ((size_t)(b * H + ya) * W + xa) * C + c;
  float4* t = tbuf + (size_t)warp * P * 32 + lane;

  for (int x = warp; x < wr; x += WARPS) {
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

bool opted = false;

}  // namespace

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
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        roi_align_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  roi_align_backward_kernel<<<(unsigned)(b * r * a.tiles), THREADS, smem_bytes(a),
                              (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
