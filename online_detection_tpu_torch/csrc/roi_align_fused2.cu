// RoIAlign as two separable contractions on Hopper, legacy-Detectron
// semantics, NHWC.
//
// Replaces: online_detection_tpu/ops/roi_align.py::roi_align_fused2 (body
// _fused2_kernel). features [B, H, W, C] x rois [B, R, 4] (xyxy, image
// coordinates) -> [B, R, P, P, C] in the features' dtype. The harvest pass
// pools GT ++ proposal boxes through it.
//
// The function is the TPU kernel's: out[p, q] = sum_{h, w} A[p, h] F[h, w]
// B[q, w] with A, B the averaged-bilinear interpolation matrices of the
// RoI's two axes (n = clip(ceil(size / P), 1, 8) samples per bin and axis at
// start + (p + (s + .5) / n) * size / P; a sample with coordinate < -1 or
// > dim contributes 0, otherwise it is clamped to [0, dim - 1]). The TPU
// kernel computes it as two MXU matmuls, the second block-diagonal over a
// tile of RoIs with an (8, 128) regroup between them; both exist only for
// the MXU and are not carried over.
//
// What bounds it on an H100: memory traffic, as for the direct kernel
// (roi_align.cu): per harvest batch of 8 at 608x800 the output is 320 RoIs
// x 196 bins x 1024 channels (1.03 GB in bf16) while the feature map (31 MB)
// sits in the 50 MB L2. A row of A has at most 2n non-zeros, so stage 1
// does O(n) work per output row and axis where direct per-bin sampling does
// O(n^2) per bin: that matters for the large GT boxes of harvest (n = 8).
//
// Design: one block per (RoI, tile of 64 channels); each lane owns two
// adjacent channels, so every feature read and output write is a coalesced
// NHWC row segment. The block first tabulates the RoI's sample rows and
// columns (tap indices and weights) in shared memory. Then, one pooled row
// p at a time: stage 1 contracts H over only the rows that row p of A
// touches, for only the columns [w0, w1] that B touches, into a
// [w1 - w0 + 1, 64] fp32 slice in shared memory; stage 2 contracts W from
// that slice for the P outputs of row p. Keeping one pooled row's slice
// (not the [P, W, 64] intermediate of the whole RoI) bounds shared memory
// at W * 64 * 4 bytes: 12.8 KB at W = 50, 21.5 KB at the 1333-pixel
// maximum W = 84. Accumulation is fp32 and the output is rounded once, so
// it is at least as accurate as the TPU kernel, which rounds A, B and the
// stage-1 result to the feature dtype.

#include <cuda_bf16.h>
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

// Sample s of bin p on one axis: tap rows lo/hi and their weights (0 for a
// sample outside [-1, dim]).
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

  // tap columns grow with (q, s): B touches only [w0, w1]
  const int w0 = xlo[0];
  const int w1 = xhi[pooled * nw - 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ch = blockIdx.y * CT + 2 * lane;
  const bool live = ch < c;  // c is even, so ch + 1 < c too
  const float inv = 1.f / (fnh * fnw);
  const T* fb = feats + (long long)b * h * w * c + ch;
  float* srow = slice + 2 * lane;

  for (int p = 0; p < pooled; ++p) {
    // stage 1: slice[x] = sum_h A[p, h] F[h, x] over row p's 2 * nh taps
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
    // stage 2: out[p, q] = sum_w slice[w] B[q, w] over bin q's 2 * nw taps
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

// Widest feature map the kernel takes: one pooled row's fp32 slice of all W
// columns x 64 channels must fit the default 48 KB of dynamic shared memory.
extern "C" int odt_roi_align_fused2_max_width() {
  return MAX_SLICE_BYTES / (CT * (int)sizeof(float));
}

// feats: [b, h, w, c] float32 (dtype 0) or bfloat16 (dtype 1), c even, 8-byte
// aligned; rois: [b, r, 4] fp32; out: [b, r, pooled, pooled, c] in feats'
// dtype.
extern "C" int odt_roi_align_fused2(const void* feats, const void* rois, void* out, int b,
                                    int r, int h, int w, int c, int pooled,
                                    float spatial_scale, int dtype, void* stream) {
  if (b * r == 0) return 0;
  if (pooled < 1 || pooled > MAX_POOLED || c < 2 || c % 2 != 0 || h < 1 || w < 1 ||
      w > odt_roi_align_fused2_max_width() || (c + CT - 1) / CT > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(feats, rois, out, b, r, h, w, c, pooled, spatial_scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feats, rois, out, b, r, h, w, c, pooled, spatial_scale,
                                 stream);
  return (int)cudaErrorInvalidValue;
}
