// Fused ResNet stem on Hopper: conv 7x7/2 pad 3 -> frozen-BN scale/bias ->
// ReLU -> maxpool 3x3/2 pad 1, NHWC, 3 -> 64 channels.
//
// Replaces: online_detection_tpu/ops/stem_pool.py::stem_fused (body
// _stem_kernel). Only the pooled [B, H4, W4, 64] tile is written; the
// [B, H/2, W/2, 64] conv activation (125 MB per batch of 8 canvases of
// 608x800 in bf16) never reaches device memory.
//
// What bounds it on an H100: the conv is 2*147*64 FLOP per conv output
// (18 GFLOP per batch of 8 at 608x800) against ~12 MB of input and ~31 MB
// of output. As an implicit GEMM, [conv positions, 147] x [147, 64] with
// K = 7*7*3 = 147, bf16 inputs and fp32 accumulation, it fits the tensor
// cores: at their 989 TFLOP/s bf16 rate the card's bound is ~0.02 ms, set
// about equally by operations and bytes. This first version does not reach
// for that bound: it runs fp32 FMA on the CUDA cores (67 TFLOP/s, so at
// best ~0.27 ms). bf16 products are exact in fp32, so it accumulates exactly
// what the TPU's MXU did (bf16 inputs, fp32 accumulation). Its FMA operands
// come from shared memory, so shared loads per FMA set its rate. A wgmma
// implicit-GEMM version is later work.
//
// Design: the Pallas kernel holds a whole padded image in VMEM; that does
// not fit 227 KB of shared memory, so each block takes a tile of TPH x TPW
// pooled outputs. It stages the (4*TPH+7) x (4*TPW+7) x 3 input patch and
// the 7x7x3x64 weights (HWIO) in shared memory (fp32), computes the
// (2*TPH+1) x (2*TPW+1) x 64 conv outputs the pool needs (a one-row and
// one-column halo shared with the neighbouring tiles), applies scale, bias
// and ReLU in fp32 and keeps them in shared memory, then takes the 3x3/2
// max. In the conv each thread owns 4 channels (one float4 of weights per
// tap) and PPT positions 16 apart, so a tap costs it 1 + PPT shared loads
// for 4 * PPT FMAs. Conv positions outside the conv map hold 0: the pool's
// zero padding is exact because ReLU >= 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int COUT = 64;
constexpr int CIN = 3;
constexpr int K = 7;
constexpr int TPH = 4;  // pooled rows per block
constexpr int TPW = 8;  // pooled cols per block
constexpr int CH = 2 * TPH + 1;  // conv rows per block
constexpr int CW = 2 * TPW + 1;  // conv cols per block
constexpr int IH = 2 * (CH - 1) + K;  // input rows per block
constexpr int IW = 2 * (CW - 1) + K;  // input cols per block
constexpr int THREADS = 256;
constexpr int GROUPS = COUT / 4;                 // channel groups of 4 (one float4)
constexpr int LANES = THREADS / GROUPS;          // position lanes
constexpr int PPT = (CH * CW + LANES - 1) / LANES;  // conv positions per thread
constexpr int XS_FLOATS = (IH * IW * CIN + 3) / 4 * 4;  // keeps cs 16-byte aligned

constexpr size_t SMEM_BYTES =
    sizeof(float) * (K * K * CIN * COUT + XS_FLOATS + CH * CW * COUT);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stem_kernel(const T* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ bias,
            T* __restrict__ out, int h, int wd, int h2, int w2, int h4, int w4) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                         // [K][K][CIN][COUT]
  float* xs = ws + K * K * CIN * COUT;      // [IH][IW][CIN]
  float* cs = xs + XS_FLOATS;               // [CH][CW][COUT]

  const int b = blockIdx.z;
  const int ph0 = blockIdx.y * TPH;
  const int pw0 = blockIdx.x * TPW;
  const int cy0 = 2 * ph0 - 1;  // first conv row of the tile
  const int cx0 = 2 * pw0 - 1;
  const int iy0 = 2 * cy0 - 3;  // first input row of the tile
  const int ix0 = 2 * cx0 - 3;
  const int tid = threadIdx.x;

  for (int i = tid; i < K * K * CIN * COUT; i += THREADS) ws[i] = w[i];
  const T* xb = x + (long long)b * h * wd * CIN;
  for (int i = tid; i < IH * IW * CIN; i += THREADS) {
    const int ci = i % CIN;
    const int c = (i / CIN) % IW;
    const int r = i / (CIN * IW);
    const int gy = iy0 + r, gx = ix0 + c;
    xs[i] = (gy >= 0 && gy < h && gx >= 0 && gx < wd)
                ? to_f32(xb[((long long)gy * wd + gx) * CIN + ci])
                : 0.f;
  }
  __syncthreads();

  const int grp = tid % GROUPS;  // channels 4*grp .. 4*grp+3
  const int lane = tid / GROUPS;  // positions lane, lane + LANES, ...
  int xoff[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = min(lane + LANES * j, CH * CW - 1);  // spare slots recompute the last one
    xoff[j] = (2 * (p / CW) * IW + 2 * (p % CW)) * CIN;
  }
  float acc[PPT][4];
#pragma unroll
  for (int j = 0; j < PPT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 1
  for (int ky = 0; ky < K; ++ky) {
#pragma unroll
    for (int kx = 0; kx < K; ++kx)
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) {
        const float4 wv = *reinterpret_cast<const float4*>(
            ws + ((ky * K + kx) * CIN + ci) * COUT + 4 * grp);
        const int tap = (ky * IW + kx) * CIN + ci;
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          const float xv = xs[xoff[j] + tap];
          acc[j][0] = fmaf(xv, wv.x, acc[j][0]);
          acc[j][1] = fmaf(xv, wv.y, acc[j][1]);
          acc[j][2] = fmaf(xv, wv.z, acc[j][2]);
          acc[j][3] = fmaf(xv, wv.w, acc[j][3]);
        }
      }
  }
  float sc[4], bi[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sc[e] = scale[4 * grp + e];
    bi[e] = bias[4 * grp + e];
  }
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = lane + LANES * j;
    if (p < CH * CW) {
      const int gy = cy0 + p / CW, gx = cx0 + p % CW;
      const bool inside = gy >= 0 && gy < h2 && gx >= 0 && gx < w2;
      float v[4];  // outside the conv map: the pool's zero padding
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = inside ? fmaxf(acc[j][e] * sc[e] + bi[e], 0.f) : 0.f;
      *reinterpret_cast<float4*>(cs + p * COUT + 4 * grp) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();

  const int o = tid % COUT;
  T* ob = out + (long long)b * h4 * w4 * COUT;
  for (int p = tid / COUT; p < TPH * TPW; p += THREADS / COUT) {
    const int ly = p / TPW, lx = p % TPW;
    const int py = ph0 + ly, px = pw0 + lx;
    if (py >= h4 || px >= w4) continue;
    float m = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        m = fmaxf(m, cs[((2 * ly + dy) * CW + 2 * lx + dx) * COUT + o]);
    ob[((long long)py * w4 + px) * COUT + o] = from_f32<T>(m);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, const void* bias, void* out,
           int b, int h, int wd, void* stream) {
  const int h2 = (h + 6 - K) / 2 + 1, w2 = (wd + 6 - K) / 2 + 1;
  const int h4 = (h2 - 1) / 2 + 1, w4 = (w2 - 1) / 2 + 1;
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w4 + TPW - 1) / TPW, (h4 + TPH - 1) / TPH, b);
  stem_kernel<T><<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)w, (const float*)scale, (const float*)bias, (T*)out, h,
      wd, h2, w2, h4, w4);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [b, h, wd, 3] NHWC, float32 (dtype 0) or bfloat16 (dtype 1); w: [7, 7, 3, 64]
// HWIO fp32 (already rounded to x's dtype by the caller); scale, bias: [64] fp32;
// out: [b, h4, w4, 64] in x's dtype, h4 = ceil(ceil(h/2)/2) (same for w4).
extern "C" int odt_stem_fused(const void* x, const void* w, const void* scale,
                              const void* bias, void* out, int b, int h, int wd,
                              int dtype, void* stream) {
  if (dtype == 0) return launch<float>(x, w, scale, bias, out, b, h, wd, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, scale, bias, out, b, h, wd, stream);
  return (int)cudaErrorInvalidValue;
}
