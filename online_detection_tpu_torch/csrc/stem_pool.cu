// Fused ResNet stem on Hopper: conv 7x7/2 pad 3 -> frozen-BN scale/bias ->
// ReLU -> maxpool 3x3/2 pad 1, NHWC, 3 -> 64 channels.
//
// Replaces: online_detection_tpu/ops/stem_pool.py::stem_fused (body
// _stem_kernel). Only the pooled [B, H4, W4, 64] tile is written; the
// [B, H/2, W/2, 64] conv activation (125 MB per batch of 8 canvases of
// 608x800 in bf16) never reaches device memory.
//
// What bounds it on an H100: the conv is 2*147*64 FLOP per conv output
// (18.3 GFLOP per batch of 8 at 608x800) against ~23 MB of input and ~31 MB
// of output. As an implicit GEMM, [conv positions, 147] x [147, 64] with
// bf16 inputs and fp32 accumulation, it sits on the card's bf16 ridge: at
// 989 TFLOP/s its bound is ~0.019 ms, set about equally by operations and
// bytes. Two routes, chosen by x's dtype behind one entry point:
//
// bf16 (the main path): stem_kernel_mma, an implicit GEMM on the tensor
// cores, mma.sync.m16n8k16 bf16 x bf16 -> fp32. bf16 products are exact in
// fp32, so it accumulates what the TPU's MXU did, up to summation order.
// Each block takes TPH x TPW = 8 x 16 pooled outputs, i.e. 17 x 33 = 561
// conv positions (36 m16 tiles, one row and one column of halo shared with
// the neighbouring tiles), and stages in shared memory the bf16 input patch
// (39 rows of 72 pixels, rows padded to RS elements), the weights packed by
// the wrapper in the order the B fragments read them (one conflict-free
// 16-byte load gives two n8 tiles of a k-step), and scale and bias. K runs
// over 20 "quads" of 4 (tap, channel) pairs: a quad is 4 pairs along one
// filter row or one pair in 4 filter rows (QUAD table below), so thread t of
// a quad reads its pair at a fixed offset plus 2t or RS*t from its conv
// position's patch corner: every A element is a 32-bit shared load at a
// compile-time offset from one of two registers, and the zero-weight slots
// (filter column 7) read real, finite pixels. K = 160 = 147 taps + 13 slots
// of zero weight. RS = 240 puts the 4 rows of a vertical quad in distinct
// banks. Each warp runs two m16 tiles at a time, so one B load feeds 4
// mma. The epilogue loads each channel pair's scale and bias once a pass,
// applies them (one fma, as the SIMT route) and ReLU in fp32, writes 0 at
// conv positions outside the conv map (the pool's zero padding, exact since
// ReLU >= 0) and rounds to bf16 into a shared conv tile (rounding is
// monotonic, so max-then-round equals round-then-max) whose 16-byte channel
// chunks are XOR-swizzled by row; then the block takes the 3x3/2 max, 8
// channels (16 bytes) a thread: a warp stores 4 pooled pixels, 512
// contiguous bytes. The patch loads (2-byte: a patch row starts at any
// element) are all in flight before any is stored, so a block waits one
// memory latency, not one per batch of loads.
//
// What holds it at ~7x its bound: a block's phases (patch loads, products
// and epilogue, pool) follow each other between barriers, and ~111 KB of
// shared memory leaves 2 blocks an SM to overlap them; in the products the
// tensor pipe runs at about half its mma.sync rate. B held in registers, a
// row-first pool, a persistent grid that loads the next patch during the
// pool, an 8 x 8 tile at 3 blocks an SM and 9 warps of one m tile each
// measured no faster on an H100, so this simpler form stays.
//
// fp32 (compute_dtype="float32", off the main path): stem_kernel<float>,
// fp32 FMA on the CUDA cores, the SIMT kernel the bf16 route replaced, kept
// unchanged. It stages the input patch and the 7x7x3x64 HWIO weights as
// fp32 for a 4 x 8 pooled tile; each thread owns 4 channels and PPT conv
// positions 16 apart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

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

// ---------------------------------------------------------------------------
// bf16 route: implicit GEMM on mma.sync

namespace tc {

constexpr int TPH = 8;                 // pooled rows per block
constexpr int TPW = 16;                // pooled cols per block
constexpr int CH = 2 * TPH + 1;        // conv rows per block
constexpr int CW = 2 * TPW + 1;        // conv cols per block
constexpr int M = CH * CW;             // conv positions per block (561)
constexpr int MTILES = (M + 15) / 16;  // m16 tiles (36)
constexpr int IH = 2 * (CH - 1) + K;   // patch rows (39)
constexpr int PW = 2 * (CW - 1) + 8;   // patch cols: the taps' 7 and the zero-weight 8th
constexpr int RS = 240;                // patch row stride, elements (120 words = 24 mod 32)
constexpr int KSTEPS = 10;             // k16 steps: K = 160
constexpr int NT = COUT / 8;           // n8 tiles (8)
constexpr int WARPS = 6;
constexpr int THREADS = 32 * WARPS;
constexpr int MT = 2;                  // m16 tiles a warp runs at a time
constexpr int PASSES = MTILES / (WARPS * MT);
static_assert(PASSES * WARPS * MT == MTILES, "the warps share the m tiles evenly");
static_assert(PW * CIN <= RS, "a patch row fits its stride");

constexpr int PATCH_ELEMS = IH * RS;
constexpr int W_ELEMS = 16 * KSTEPS * COUT;  // the packed weights
constexpr size_t SMEM_BYTES = 2 * PATCH_ELEMS + 2 * W_ELEMS + 4 * 2 * COUT + 2 * M * COUT;
static_assert(PATCH_ELEMS * 2 % 16 == 0 && W_ELEMS * 2 % 16 == 0, "16-byte aligned regions");

// K order. Slot k = 8q + 2t + e (quad q, thread-in-group t, element e): the
// pair t of quad q is filter row ky + t*down, pair index p + t*(1 - down),
// and pair p of a filter row holds its elements 2p, 2p + 1 in (kx, ci)
// order, 21 real ones (kx < 7) and 3 of zero weight (kx = 7). Rows 0-3 are
// 11 vertical quads, rows 4-6 three horizontal quads each. The wrapper's
// weight packing (ops/stem_pool.py, STEM_QUADS) reads the same table.
struct Quad {
  int ky, pair, down;
};
__host__ __device__ constexpr Quad quad(int q) {
  // QUADS-BEGIN
  const Quad table[20] = {
      {0, 0, 1}, {0, 1, 1}, {0, 2, 1}, {0, 3, 1}, {0, 4, 1}, {0, 5, 1}, {0, 6, 1},
      {0, 7, 1}, {0, 8, 1}, {0, 9, 1}, {0, 10, 1},
      {4, 0, 0}, {4, 4, 0}, {4, 8, 0},
      {5, 0, 0}, {5, 4, 0}, {5, 8, 0},
      {6, 0, 0}, {6, 4, 0}, {6, 8, 0},
  };
  // QUADS-END
  return table[q];
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k16 step: A from the patch (quads 2S and 2S + 1, rows g and g + 8 of
// each m tile), B from the packed weights, 8 n8 tiles for each of MT m tiles.
// hb / vb: the rows' patch corners plus 2t / RS*t (horizontal / vertical quads).
template <int S>
__device__ __forceinline__ void kstep(float (&acc)[MT][NT][4], const __nv_bfloat16* patch,
                                      const uint4* wq, const int (&hb)[MT][2],
                                      const int (&vb)[MT][2], int lane) {
  constexpr Quad q0 = quad(2 * S), q1 = quad(2 * S + 1);
  constexpr int off0 = q0.ky * RS + 2 * q0.pair, off1 = q1.ky * RS + 2 * q1.pair;
  uint32_t a[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      a[mt][r] = lds32(patch + (q0.down ? vb[mt][r] : hb[mt][r]) + off0);
      a[mt][2 + r] = lds32(patch + (q1.down ? vb[mt][r] : hb[mt][r]) + off1);
    }
  }
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    const uint4 bv = wq[(S * (NT / 2) + j) * 32 + lane];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16(acc[mt][2 * j], a[mt], bv.x, bv.y);
      mma_bf16(acc[mt][2 * j + 1], a[mt], bv.z, bv.w);
    }
  }
}

template <int... S>
__device__ __forceinline__ void ksteps(std::integer_sequence<int, S...>, float (&acc)[MT][NT][4],
                                       const __nv_bfloat16* patch, const uint4* wq,
                                       const int (&hb)[MT][2], const int (&vb)[MT][2], int lane) {
  (kstep<S>(acc, patch, wq, hb, vb, lane), ...);
}

__global__ void __launch_bounds__(THREADS, 2)
stem_kernel_mma(const __nv_bfloat16* __restrict__ x, const uint4* __restrict__ wpack,
                const float* __restrict__ scale, const float* __restrict__ bias,
                __nv_bfloat16* __restrict__ out, int h, int wd, int h2, int w2, int h4,
                int w4) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* patch = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [IH][RS]
  uint4* wq = reinterpret_cast<uint4*>(patch + PATCH_ELEMS);          // fragment order
  float* sc = reinterpret_cast<float*>(wq + W_ELEMS / 8);              // [64] scale, [64] bias
  __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(sc + 2 * COUT);  // [M][64], swizzled

  const int b = blockIdx.z;
  const int ph0 = blockIdx.y * TPH;
  const int pw0 = blockIdx.x * TPW;
  const int cy0 = 2 * ph0 - 1;  // first conv row of the tile
  const int cx0 = 2 * pw0 - 1;
  const int iy0 = 2 * cy0 - 3;  // first input row of the tile
  const int ix0 = 2 * cx0 - 3;
  const int tid = threadIdx.x;

  // stage: the weights (16-byte copies), scale and bias, and the input patch
  // (each patch row is one contiguous run of PW * 3 elements of x; zero
  // outside the image)
  for (int i = tid; i < W_ELEMS / 8; i += THREADS) wq[i] = wpack[i];
  if (tid < COUT) {
    sc[tid] = scale[tid];
    sc[COUT + tid] = bias[tid];
  }
  // all the patch loads are in flight before any is stored: one memory latency
  const __nv_bfloat16* xb = x + (long long)b * h * wd * CIN;
  constexpr int LOADS = (IH * PW * CIN + THREADS - 1) / THREADS;
  __nv_bfloat16 v[LOADS];
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int i = tid + k * THREADS;
    const int r = i / (PW * CIN), e = i - r * (PW * CIN);
    const int gy = iy0 + r, ge = ix0 * CIN + e;  // element column within the image row
    v[k] = (i < IH * PW * CIN && gy >= 0 && gy < h && ge >= 0 && ge < wd * CIN)
               ? xb[(long long)gy * wd * CIN + ge]
               : __float2bfloat16(0.f);
  }
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int i = tid + k * THREADS;
    const int r = i / (PW * CIN);
    if (i < IH * PW * CIN) patch[r * RS + i - r * (PW * CIN)] = v[k];
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int pass = 0; pass < PASSES; ++pass) {
    const int mt0 = (pass * WARPS + warp) * MT;
    int hb[MT][2], vb[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = min(16 * (mt0 + mt) + g + 8 * r, M - 1);  // spare rows redo the last
        const int base = 2 * (m / CW) * RS + 2 * CIN * (m % CW);
        hb[mt][r] = base + 2 * t;
        vb[mt][r] = base + RS * t;
      }
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
    ksteps(std::make_integer_sequence<int, KSTEPS>{}, acc, patch, wq, hb, vb, lane);

    // epilogue: scale and bias (one fma), ReLU; 0 outside the conv map; bf16
    // into the conv tile, 16-byte chunk j of row m at chunk j ^ (m & 7)
    bool inside[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = 16 * (mt0 + mt) + g + 8 * r;
        const int gy = cy0 + m / CW, gx = cx0 + m % CW;
        inside[mt][r] = gy >= 0 && gy < h2 && gx >= 0 && gx < w2;
      }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 s2 = *reinterpret_cast<const float2*>(sc + 8 * j + 2 * t);
      const float2 b2 = *reinterpret_cast<const float2*>(sc + COUT + 8 * j + 2 * t);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = 16 * (mt0 + mt) + g + 8 * r;
          if (m >= M) continue;
          __nv_bfloat162 o = __floats2bfloat162_rn(fmaxf(fmaf(acc[mt][j][2 * r], s2.x, b2.x), 0.f),
                                                   fmaxf(fmaf(acc[mt][j][2 * r + 1], s2.y, b2.y), 0.f));
          if (!inside[mt][r]) o = __floats2bfloat162_rn(0.f, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(conv + m * COUT + 8 * (j ^ (m & 7)) + 2 * t) = o;
        }
    }
  }
  __syncthreads();

  // 3x3/2 max over the conv tile: 8 channels (one 16-byte chunk) a thread,
  // 8 threads a pooled pixel
  __nv_bfloat16* ob = out + (long long)b * h4 * w4 * COUT;
  for (int i = tid; i < TPH * TPW * 8; i += THREADS) {
    const int chunk = i & 7, p = i >> 3;
    const int ly = p / TPW, lx = p % TPW;
    const int py = ph0 + ly, px = pw0 + lx;
    if (py >= h4 || px >= w4) continue;
    __align__(16) __nv_bfloat162 best[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) best[e] = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int m = (2 * ly + dy) * CW + 2 * lx + dx;
        const uint4 v = *reinterpret_cast<const uint4*>(conv + m * COUT + 8 * (chunk ^ (m & 7)));
        const __nv_bfloat162* pv = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) best[e] = __hmax2(best[e], pv[e]);
      }
    *reinterpret_cast<uint4*>(ob + ((long long)py * w4 + px) * COUT + 8 * chunk) =
        *reinterpret_cast<const uint4*>(best);
  }
}

int launch(const void* x, const void* wpack, const void* scale, const void* bias, void* out,
           int b, int h, int wd, void* stream) {
  const int h2 = (h + 6 - K) / 2 + 1, w2 = (wd + 6 - K) / 2 + 1;
  const int h4 = (h2 - 1) / 2 + 1, w4 = (w2 - 1) / 2 + 1;
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w4 + TPW - 1) / TPW, (h4 + TPH - 1) / TPH, b);
  stem_kernel_mma<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const uint4*)wpack, (const float*)scale, (const float*)bias,
      (__nv_bfloat16*)out, h, wd, h2, w2, h4, w4);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x: [b, h, wd, 3] NHWC, float32 (dtype 0) or bfloat16 (dtype 1); out: [b, h4, w4, 64]
// in x's dtype, h4 = ceil(ceil(h/2)/2) (same for w4); scale, bias: [64] fp32.
// w: for float32, [7, 7, 3, 64] HWIO fp32; for bfloat16, the [160 x 64] bf16
// weights in the B fragments' order (ops/stem_pool.py::pack_stem_weights).
extern "C" int odt_stem_fused(const void* x, const void* w, const void* scale,
                              const void* bias, void* out, int b, int h, int wd,
                              int dtype, void* stream) {
  if (dtype == 0) return launch<float>(x, w, scale, bias, out, b, h, wd, stream);
  if (dtype == 1) return tc::launch(x, w, scale, bias, out, b, h, wd, stream);
  return (int)cudaErrorInvalidValue;
}
