// RoIAlign body shared by kernels B3 (roi_align.cu) and B4
// (roi_align_fused2.cu): legacy-Detectron semantics, NHWC, features
// [B, H, W, C] x rois [B, R, 4] (xyxy, image coordinates) -> [B, R, P, P, C]
// in the features' dtype.
//
// The function: out[p, q] = sum_{y, x} A[p, y] F[y, x] B[q, x], with A, B
// the averaged-bilinear interpolation matrices of the RoI's two axes
// (start = coord * scale, size = max(end - start, 1), n = clip(ceil(size /
// P), 1, 8) samples per bin and axis at start + (p + (s + .5) / n) * size /
// P; a sample with coordinate < -1 or > dim contributes 0, otherwise it is
// clamped to [0, dim - 1] and interpolated bilinearly; each row of A and B
// is divided by its n).
//
// What bounds it on an H100: the output. The main-path calls write 0.3-1
// GB of bf16 each against a 31 MB feature map in the 50 MB L2, and their
// boxes are small (a bin narrower than a feature cell, one sample per bin and
// axis, for most of them): the RoIs touch fewer feature bytes than they
// write. So the kernel has to stream its stores and keep the few
// instructions per output element from stalling on the feature loads.
//
// Design (H first, one warp per output row). A block takes one RoI and one
// channel tile of 32 lanes x 16 bytes (256 bf16 channels); each lane owns one
// 16-byte channel vector. The block tabulates the RoI's A and B densely in
// shared memory, once, over the rows and columns the RoI touches (taps grow
// with (bin, sample), so these run from the first tap to the last), and
// then each warp takes pooled rows p: it contracts H into
// U[x] = sum_y A[p, y] F[y, x] for the columns x in order, CH columns at a
// time with both rows' 16-byte loads of all CH columns in flight together
// (read-only, L2 evict-last), into a lane-private ring of RING columns in
// shared memory, and ahead as far as the ring holds; then
// out[p, q] = sum_x B[q, x] U[x] over the columns bin q touches, from the
// ring, or from two registers when consecutive bins share their column pair.
// Every control decision depends on (p, q) only, so it is uniform across the
// warp; a lane reads only what it wrote, so the warps never wait for one
// another after the tables. Each output row leaves as P stores of 512
// contiguous bytes a warp, with an L2 evict-first policy. Accumulation is
// fp32 and the output is rounded once. The registers are capped so that an
// SM holds MIN_BLOCKS blocks: the loads' latency is hidden by other warps.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace roi {

constexpr int MAX_SAMPLES = 8;
constexpr int MAX_POOLED = 32;
constexpr int MAX_DIM = 128;          // largest H and W (a 1333-pixel side is 84 at 1/16)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RING = 8;               // H-contracted columns a lane keeps
constexpr int CH = 4;                 // columns contracted together, their loads in flight
constexpr int MIN_BLOCKS = 5;         // blocks an SM must hold (caps the registers)

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

struct Args {
  const void* feats;
  const float* rois;
  void* out;
  int r_per_img, h, w, c, pooled;
  float scale;
  int tiles;  // channel tiles of 32 lanes x 16 bytes: blocks per RoI
};

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// read-only: the features do not change while a kernel runs
__device__ __forceinline__ uint4 load16(const void* gmem, uint64_t pol) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(gmem), "l"(pol));
  return v;
}

__device__ __forceinline__ void store16(void* gmem, uint4 v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;\n"
               :: "l"(gmem), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(pol) : "memory");
}

// 16 bytes of features -> N floats
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// N floats -> 16 bytes of output, rounded to nearest even once
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// One axis of one RoI: box edges lo, hi in image coordinates. The sample
// coordinates are rounded op by op as the plain version rounds them (the
// _rn intrinsics are never contracted into FMAs): a sample moved by an ulp
// of its coordinate changes the bilinear weights by as much.
struct Axis {
  float start, bin, n;
  int dim;

  __device__ __forceinline__ Axis(float lo, float hi, float scale, int pooled, int dim_)
      : dim(dim_) {
    start = __fmul_rn(lo, scale);
    bin = __fdiv_rn(fmaxf(__fsub_rn(__fmul_rn(hi, scale), start), 1.f), (float)pooled);
    n = fminf(fmaxf(ceilf(bin), 1.f), (float)MAX_SAMPLES);
  }

  // sample s of bin p: tap rows lo, hi and their weights (0 for a sample
  // outside [-1, dim])
  __device__ __forceinline__ void tap(int p, int s, int& lo, int& hi, float& wlo,
                                      float& whi) const {
    const float coord =
        __fadd_rn(start, __fmul_rn(__fadd_rn((float)p, __fdiv_rn((float)s + 0.5f, n)), bin));
    const bool in_range = coord >= -1.f && coord <= (float)dim;
    const float c = fminf(fmaxf(coord, 0.f), (float)dim - 1.f);
    const float low = floorf(c);
    const float frac = c - low;
    lo = (int)low;
    hi = min((int)low + 1, dim - 1);
    wlo = in_range ? 1.f - frac : 0.f;
    whi = in_range ? frac : 0.f;
  }

  __device__ __forceinline__ int first() const {
    int lo, hi;
    float a, b;
    tap(0, 0, lo, hi, a, b);
    return lo;
  }
  __device__ __forceinline__ int last(int pooled) const {
    int lo, hi;
    float a, b;
    tap(pooled - 1, (int)n - 1, lo, hi, a, b);
    return hi;
  }

  // Row p of the dense matrix over [base, base + span): weights summed over
  // the samples, divided by n; range[0..1] = the first and last tap.
  __device__ __forceinline__ void fill(int p, int base, float* row, int* range) const {
    const int ns = (int)n;
    int first = 0, last = 0;
    for (int s = 0; s < ns; ++s) {
      int lo, hi;
      float wlo, whi;
      tap(p, s, lo, hi, wlo, whi);
      row[lo - base] += wlo;
      row[hi - base] += whi;
      if (s == 0) first = lo;
      last = hi;
    }
    for (int k = first - base; k <= last - base; ++k) row[k] /= n;
    range[0] = first - base;
    range[1] = last - base;
  }
};

// Dynamic shared memory a launch needs.
inline size_t smem_bytes(const Args& a, int vec) {
  return sizeof(float) * a.pooled * (a.h + a.w) + sizeof(int) * 4 * a.pooled +
         sizeof(float) * WARPS * RING * 32 * vec;
}

// Sets a.tiles; cudaErrorInvalidValue for a shape the kernel does not take.
inline int plan(Args& a, int vec, int b, int r) {
  if (a.pooled < 1 || a.pooled > MAX_POOLED || a.h < 1 || a.w < 1 || a.h > MAX_DIM ||
      a.w > MAX_DIM || a.c < vec || a.c % vec != 0 || r < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  a.tiles = (a.c / vec + 31) / 32;
  if ((long long)b * r * a.tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
__device__ __forceinline__ void pool_rows(const Args& a) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(16) float smem[];
  const int P = a.pooled, H = a.h, W = a.w, C = a.c;
  float* ring = smem;                                   // [WARPS][RING][32][V]
  float* ad = ring + WARPS * RING * 32 * V;             // [P][H]: A over [ya, yb]
  float* bd = ad + P * H;                               // [P][W]: B over [xa, xb]
  int* prange = reinterpret_cast<int*>(bd + P * W);     // [P][2], relative to ya
  int* qrange = prange + 2 * P;                         // [P][2], relative to xa

  const int roi = blockIdx.x / a.tiles;
  const int b = roi / a.r_per_img;
  const float* box = a.rois + (size_t)roi * 4;
  const Axis ay(box[1], box[3], a.scale, P, H);
  const Axis ax(box[0], box[2], a.scale, P, W);
  const int ya = ay.first(), xa = ax.first();
  const int wr = ax.last(P) - xa + 1;  // columns the RoI touches

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
  const uint64_t pol_last = policy_evict_last(), pol_first = policy_evict_first();
  const T* fimg = reinterpret_cast<const T*>(a.feats) +
                  ((size_t)(b * H + ya) * W + xa) * C;       // feature (ya, xa)
  // lane l's U[x] is in slot x % RING: its float4 h at (slot * V / 4 + h) * 32 + l
  // float4s, so that a warp's 16-byte accesses cover 512 contiguous bytes
  float4* lring = reinterpret_cast<float4*>(ring) + (size_t)warp * RING * 8 * V + lane;

  // lane l owns V channels of the block's tile
  const int c = (blockIdx.x % a.tiles) * 32 * V + lane * V;
  const bool live = c < C;
  const T* fp = fimg + c;
  // A warp writes output rows out[p, :, tile], every control decision
  // uniform across it.
  for (int p = warp; p < P; p += WARPS) {
    const int pa = prange[2 * p], pb = prange[2 * p + 1];
    const float* arow = ad + p * H;
    T* orow = reinterpret_cast<T*>(a.out) + ((size_t)roi * P + p) * P * C + c;

    // U[x] = sum_y A[p, y] F[y, x] for this lane's channels, for the columns
    // [x0, x0 + cnt), cnt <= CH, into the lane's ring. Rows go in pairs: the
    // loads of a pair for all cnt columns are in flight together; a column
    // is summed into its ring slot right after its loads arrive, so only the
    // loads stay live across the chunk.
    auto columns = [&](int x0, int cnt) {
      if (!live) return;
      for (int y = pa; y <= pb; y += 2) {
        const bool two = y < pb, first = y == pa;
        const float w0 = arow[y], w1 = two ? arow[y + 1] : 0.f;
        const T* f0 = fp + ((size_t)y * W + x0) * C;
        uint4 r0[CH], r1[CH];
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          if (k < cnt) {
            r0[k] = load16(f0 + (size_t)k * C, pol_last);
            if (two) r1[k] = load16(f0 + (size_t)(W + k) * C, pol_last);
          }
        }
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          if (k < cnt) {
            float4* slot = lring + ((x0 + k) % RING) * 8 * V;
            float col[V], f[V];
#pragma unroll
            for (int v = 0; v < V; v += 4) {
              const float4 s4 = first ? make_float4(0.f, 0.f, 0.f, 0.f) : slot[v * 8];
              col[v] = s4.x, col[v + 1] = s4.y, col[v + 2] = s4.z, col[v + 3] = s4.w;
            }
            unpack(r0[k], f);
#pragma unroll
            for (int v = 0; v < V; ++v) col[v] = fmaf(w0, f[v], col[v]);
            if (two) {
              unpack(r1[k], f);
#pragma unroll
              for (int v = 0; v < V; ++v) col[v] = fmaf(w1, f[v], col[v]);
            }
#pragma unroll
            for (int v = 0; v < V; v += 4)
              slot[v * 8] = make_float4(col[v], col[v + 1], col[v + 2], col[v + 3]);
          }
        }
      }
    };
    // acc += B[q, x] U[x] from the ring
    auto contract = [&](const float* brow, int x, float (&acc)[V]) {
      const float wx = brow[x];
      const float4* slot = lring + (x % RING) * 8 * V;
#pragma unroll
      for (int v = 0; v < V; v += 4) {
        const float4 s4 = slot[v * 8];
        acc[v] = fmaf(wx, s4.x, acc[v]);
        acc[v + 1] = fmaf(wx, s4.y, acc[v + 1]);
        acc[v + 2] = fmaf(wx, s4.z, acc[v + 2]);
        acc[v + 3] = fmaf(wx, s4.w, acc[v + 3]);
      }
    };

    int next = 0;  // columns [next - RING, next) are in the lane's ring
    int ca = -1, cb = -1;  // U[ca], U[cb] are in ua, ub
    float ua[V], ub[V];
    for (int q = 0; q < P; ++q) {
      const int qa = qrange[2 * q], qb = qrange[2 * q + 1];
      const float* brow = bd + q * W;
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;
      if (qb - qa < RING && qa + RING >= next) {
        // columns up to qb, and ahead as far as the ring holds them
        while (next <= qb) {
          const int x0 = max(next, qa);
          const int cnt = min(CH, min(wr, qa + RING) - x0);
          columns(x0, cnt);
          next = x0 + cnt;
        }
        if (qb - qa <= 1) {  // bins narrower than a cell reuse one pair
          if (qa != ca || qb != cb) {
            const float4* sa = lring + (qa % RING) * 8 * V;
            const float4* sb = lring + (qb % RING) * 8 * V;
#pragma unroll
            for (int v = 0; v < V; v += 4) {
              const float4 a4 = sa[v * 8], b4 = sb[v * 8];
              ua[v] = a4.x, ua[v + 1] = a4.y, ua[v + 2] = a4.z, ua[v + 3] = a4.w;
              ub[v] = b4.x, ub[v + 1] = b4.y, ub[v + 2] = b4.z, ub[v + 3] = b4.w;
            }
            ca = qa, cb = qb;
          }
          const float wa = brow[qa], wb = qb > qa ? brow[qb] : 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fmaf(wb, ub[v], wa * ua[v]);
        } else {
          for (int x = qa; x <= qb; ++x) contract(brow, x, acc);
        }
      } else {  // a bin wider than the ring: contract its columns one by one
        for (int x = qa; x <= qb; ++x) {
          columns(x, 1);
          contract(brow, x, acc);
        }
        next = qb + 1;
      }
      if (live) store16(orow + (size_t)q * C, pack(acc), pol_first);
    }
  }
}

// Launches `kernel` (a __global__ wrapper of pool_rows<T>) for one call.
// `opted` holds one bit a device: the opt-in is set per device.
template <typename Kernel>
int launch(Kernel kernel, Args a, int b, int r, int vec, void* stream,
           unsigned long long* opted) {
  const int status = plan(a, vec, b, r);
  if (status) return status;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(*opted & bit)) {  // once per process, kernel and device: allow more than 48 KB
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             227 * 1024);
    if (e != cudaSuccess) return (int)e;
    *opted |= bit;
  }
  kernel<<<(unsigned)(b * r * a.tiles), THREADS, smem_bytes(a, vec),
           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace roi
