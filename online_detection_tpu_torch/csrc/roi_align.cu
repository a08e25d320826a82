// Batched RoIAlign on Hopper, legacy-Detectron semantics, NHWC.
//
// Replaces: online_detection_tpu/ops/roi_align.py::roi_align_batched (body
// _fused_pool_kernel). features [B, H, W, C] x rois [B, R, 4] (xyxy, image
// coordinates) -> [B, R, P, P, C] in the features' dtype.
//
// Semantics are those of the JAX package's _interp_matrix, sample by sample:
// start = coord * scale (no half-pixel shift), size = max(end - start, 1),
// n = clip(ceil(size / P), 1, 8) samples per bin and axis at
// start + (p + (s + .5) / n) * size / P; a sample with coordinate < -1 or
// > dim contributes 0, otherwise the coordinate is clamped to [0, dim - 1]
// and interpolated bilinearly; the sum is divided by n_h * n_w. (The
// reference CUDA op does not clamp n to 8; the JAX package does, and so does
// this kernel.)
//
// What bounds it on an H100: memory traffic. Per batch of 8 at 608x800 the
// output is 300 RoIs x 196 bins x 1024 channels (0.96 GB in bf16) while the
// feature map (31 MB in bf16) sits in the 50 MB L2; the FLOPs (4 taps x up
// to 64 samples per output) are small next to that.
//
// Design: direct per-bin sampling, no separable intermediate. A block takes
// one (RoI, pooled row); the sample coordinates and weights are computed
// once per bin and shared by all channels; threads run along C, so every
// tap's read and the output's write are coalesced NHWC rows. Accumulation
// is fp32; the output is rounded once.

#include <cuda_bf16.h>
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

// feats: [b, h, w, c] float32 (dtype 0) or bfloat16 (dtype 1); rois: [b, r, 4]
// fp32; out: [b, r, pooled, pooled, c] in feats' dtype.
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
