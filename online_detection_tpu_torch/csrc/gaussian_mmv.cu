// Grouped Gaussian-kernel matrix-vector product on Hopper (fp32, CUDA cores).
//
// Replaces: online_detection_tpu/ops/gaussian_mmv.py::mmv_pallas (body
// _mmv_kernel). Computes, for every group g with center set s = set_idx[g],
//
//   out[g, n] = sum_m exp(-max(|x_gn|^2 + |c_sm|^2 - 2 x_gn.c_sm, 0) / (2 s^2))
//               * v[s, m]
//
// One launch serves the three callers of the inference path: the RPN's 15
// anchor classifiers and the detector's 21 class classifiers (x shared by
// every group: x group stride 0), and the mask head's own-class scores (one
// group per RoI, x = its 196 pixels, set_idx = label - 1: the center gather
// is done by index, never by copying centers).
//
// What bounds it on an H100: operations. The RPN call is 2*15200*15000*1025
// ~ 4.7e11 FLOP against ~2e8 bytes of operands, far above the fp32 ridge.
// The cross term and K@v must stay IEEE fp32 (a single reduced-precision
// pass over the cancelled cross term cost det mAP 0.92 -> 0.50 on the TPU),
// so the bound is the 67 TFLOP/s fp32 CUDA-core rate, not the tensor cores.
//
// Design: an SGEMM-shaped kernel with the Gaussian and the product by v fused
// into its epilogue. Each block owns a (group, 128-row) tile and walks the
// center set in 128-center tiles. Per center tile, 16-wide chunks of x and c
// go through shared memory (transposed, double-buffered: the next chunk's
// global loads are in flight while the current one is multiplied), and each
// of the 256 threads accumulates an 8x8 block of cross terms in registers,
// reading its operands as float4 (64 FMA per 4 shared loads). The epilogue
// applies the squared norms (precomputed by the caller), max(., 0), exp, and
// multiplies by the tile's v entries into per-thread partial sums, so the
// [N, M] kernel block never reaches device memory. At the end the 16 threads
// that share a row reduce their partials with warp shuffles.
// wgmma/TMA (3xTF32 or split-bf16 emulation of fp32) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;      // x rows per block
constexpr int BM = 128;      // centers per tile
constexpr int BK = 16;       // feature chunk
constexpr int LD = BN + 4;   // shared row pitch (floats): 16-byte aligned rows
constexpr int THREADS = 256; // 16 x 16, each thread 8 x 8
constexpr int LOADS = BN * BK / 4 / THREADS;  // float4 loads per thread per operand

static_assert(BN == BM, "x and c tiles share the loader");
static_assert(LOADS == 2, "loader layout");

// Rows and columns a thread owns: 4 + 4, half a tile apart, so its shared
// reads are two float4 each and a warp's reads are broadcasts or consecutive.
__device__ __forceinline__ int owned(int lane16, int i) {
  return (i < 4) ? lane16 * 4 + i : BN / 2 + lane16 * 4 + (i - 4);
}

// Loads a [BN rows, BK] chunk of a row-major [rows, d] operand into
// registers; rows past `rows` read as 0. d % 4 == 0 and 16-byte aligned rows
// (checked by the entry point), so a float4 is all in or all out.
__device__ __forceinline__ void load_chunk(const float* __restrict__ src, int rows, int d,
                                           int k0, int tid, float4 (&buf)[LOADS]) {
#pragma unroll
  for (int q = 0; q < LOADS; ++q) {
    const int idx = tid + q * THREADS;
    const int r = idx >> 2;
    const int k = k0 + (idx & 3) * 4;
    buf[q] = (r < rows && k < d)
                 ? *reinterpret_cast<const float4*>(src + (long long)r * d + k)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void store_chunk(float (*dst)[LD], int tid,
                                            const float4 (&buf)[LOADS]) {
#pragma unroll
  for (int q = 0; q < LOADS; ++q) {
    const int idx = tid + q * THREADS;
    const int r = idx >> 2;
    const int k = (idx & 3) * 4;
    dst[k + 0][r] = buf[q].x;
    dst[k + 1][r] = buf[q].y;
    dst[k + 2][r] = buf[q].z;
    dst[k + 3][r] = buf[q].w;
  }
}

__global__ void __launch_bounds__(THREADS, 2)
mmv_grouped_kernel(const float* __restrict__ x, long long x_gstride,
                   const float* __restrict__ xs, long long xs_gstride,
                   const float* __restrict__ c, const float* __restrict__ cs,
                   const float* __restrict__ v, const int* __restrict__ set_idx,
                   float* __restrict__ out, int n, int m, int d, float two_s2) {
  __shared__ __align__(16) float Xs[2][BK][LD];
  __shared__ __align__(16) float Cs[2][BK][LD];

  const int g = blockIdx.y;
  const int n0 = blockIdx.x * BN;
  const int s = set_idx[g];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column lane: the 16 lanes of a row share a half warp
  const int ty = tid / 16;  // row lane

  const float* xg = x + (long long)g * x_gstride + (long long)n0 * d;
  const float* xsg = xs + (long long)g * xs_gstride;
  const float* cg = c + (long long)s * m * d;
  const float* csg = cs + (long long)s * m;
  const float* vg = v + (long long)s * m;
  const int n_rows = n - n0;

  float part[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) part[i] = 0.f;

  float4 xb[LOADS], cb[LOADS];
  for (int m0 = 0; m0 < m; m0 += BM) {
    const float* ct = cg + (long long)m0 * d;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    load_chunk(xg, n_rows, d, 0, tid, xb);
    load_chunk(ct, m - m0, d, 0, tid, cb);
    store_chunk(Xs[0], tid, xb);
    store_chunk(Cs[0], tid, cb);
    __syncthreads();

    int cur = 0;
    for (int k0 = 0; k0 < d; k0 += BK) {
      const bool more = k0 + BK < d;
      if (more) {  // next chunk's loads overlap this chunk's FMAs
        load_chunk(xg, n_rows, d, k0 + BK, tid, xb);
        load_chunk(ct, m - m0, d, k0 + BK, tid, cb);
      }
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&Xs[cur][k][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&Xs[cur][k][BN / 2 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Cs[cur][k][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Cs[cur][k][BM / 2 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) {  // the other buffer was last read before the previous barrier
        store_chunk(Xs[cur ^ 1], tid, xb);
        store_chunk(Cs[cur ^ 1], tid, cb);
      }
      __syncthreads();
      cur ^= 1;
    }

    float xn[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = n0 + owned(ty, i);
      xn[i] = r < n ? xsg[r] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gm = m0 + owned(tx, j);
      if (gm < m) {
        const float cn = csg[gm];
        const float vv = vg[gm];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float sq = fmaxf(xn[i] + cn - 2.f * acc[i][j], 0.f);
          part[i] = fmaf(expf(-sq / two_s2), vv, part[i]);
        }
      }
    }
  }

  // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = n0 + owned(ty, i);
      if (r < n) out[(long long)g * n + r] = part[i];
    }
  }
}

}  // namespace

// x: [G or 1, n, d] (x_gstride = n*d or 0), xs: its squared row norms with
// stride xs_gstride, c: [S, m, d], cs: [S, m], v: [S, m], set_idx: [G],
// out: [G, n]. All fp32 and contiguous, d % 4 == 0, x and c 16-byte aligned
// (else cudaErrorInvalidValue); launches on `stream`.
extern "C" int odt_mmv_grouped(const void* x, long long x_gstride, const void* xs,
                               long long xs_gstride, const void* c, const void* cs,
                               const void* v, const void* set_idx, void* out, int groups,
                               int n, int m, int d, float sigma, void* stream) {
  if (groups < 1 || groups > 65535 || n < 1 || m < 1 || d < 1 || d % 4 != 0 ||
      x_gstride % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(c) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + BN - 1) / BN, groups);
  mmv_grouped_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, x_gstride, (const float*)xs, xs_gstride, (const float*)c,
      (const float*)cs, (const float*)v, (const int*)set_idx, (float*)out, n, m, d,
      2.f * sigma * sigma);
  return (int)cudaGetLastError();
}
