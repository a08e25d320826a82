// RoIAlign backward on Hopper: the gradient of kernel B3 in the features,
// legacy-Detectron semantics, NHWC, float32.
//
// Backward of: online_detection_tpu/ops/roi_align.py::roi_align (the
// function the JAX trainer differentiates with jax.grad; the TPU kernel
// roi_align_batched computes the same forward, and no Pallas backward
// exists). grad g [B, R, P, P, C] x rois [B, R, 4] (xyxy, image coordinates)
// -> dF [B, H, W, C]:
//
//   dF[h, w, c] = sum_r sum_{p, q} A_r[p, h] B_r[q, w] g[r, p, q, c]
//
// with A_r, B_r the forward's averaged-bilinear interpolation matrices, built
// by the same device code (roi::Axis in roi_align_common.cuh), so the forward
// and the backward cannot disagree on a sample or a weight. The caller zeroes
// dF first.
//
// What bounds it on an H100: the bytes of g, read once. A training step's
// call reads 512 x 14 x 14 x 1024 f32 (411 MB) and writes a 38 x 50 x 1024
// map (7.8 MB): 0.125 ms at 3.35 TB/s. Beside that, every (RoI, feature cell
// its taps reach, channel) costs one atomic add, a read-modify-write in L2:
// a RoI whose taps reach more than P x P cells (a box wider than about 14 x
// 14 cells) sends more bytes to L2 as atomics than it reads of g. The kernel
// this one replaced read g from device memory again for every column its
// bins reach, at 21 % of the bound. This one reads g at near its stream rate
// when boxes are small (a random-weight RPN's); for boxes of real objects'
// sizes (4-12 cells a side) and larger, the row loop below takes most of
// the time, not g's stream nor the atomics' traffic
// (tools/roi_backward_variants.py splits it).
//
// Design. A work item is (RoI, tile of 128 channels, slab of pooled rows p);
// at P <= 16 one slab holds every p, so a training step has 512 x 8 items.
// Blocks are persistent, one an SM, and walk the items with a stride of
// the grid. A block is one producer warp and CONSUMERS consumer warps around
// a ring of STAGES slabs in shared memory, each signalled by a pair of
// mbarriers (full, empty):
// - the producer's lane 0 waits until the consumers have emptied a slab,
//   then brings the next item's g[r, p0:p0+pc, :, c0:c0+128] into it with
//   one TMA box of a 3-D tensor map over g seen as [B*R, P*P, C] (rows past
//   the RoI's last p and channels past C read as zeros, so a slab never
//   reaches into the next RoI and the ragged channel tile is masked), with an
//   L2 evict-first policy: each byte of g comes from device memory once.
//   Its other 31 lanes meanwhile tabulate the item beside the slab: A and B
//   densely over the rows and columns the RoI touches, the bins q reaching
//   each column, and for each row a record of the slab's bins reaching it
//   with the first three's weights; their arrivals complete the full barrier
//   with the copy's bytes.
// - the consumers split the tile into four quarters of 32 channels, one
//   channel a lane, and the warps of a quarter take the RoI's columns x in
//   turn, so every warp has an equal share of each item whatever the box's
//   shape (a small box's middle column is reached by all P bins). For
//   column x a lane forms T[k] = sum_q B[q, x] g[p0 + k, q] in registers (at
//   most 16, the bins reaching x only, the next bin's loads in flight while
//   this bin's FMAs run), reading g from shared memory, where re-reads cost
//   nothing against DRAM, and leaves a copy in a lane-private slot of shared
//   memory. Then, ROWS rows at a time with their loads in flight together,
//   it adds sum_k A[p0 + k, y] T[k] over the bins k reaching row y (the
//   record's three, or a second pass for a row that more reach: bins under
//   two thirds of a cell, as a box under about 9 cells a side has) into
//   dF[y, x] with one non-returning atomic (RED; a warp's 32 lanes cover 128
//   contiguous bytes): one atomic a (RoI, cell, channel), the fewest an
//   atomic design can send. Every control decision depends on (item, x, y)
//   only, so it is uniform across the warp.
// While the consumers contract and drain one item's atomics, the next item's
// slab is in flight. The second pass is unrolled over the rows (its loads in
// flight together), but no loop over the bins is unrolled outside the
// contraction, and T is not kept in registers for the rows: with two
// consumer warps a scheduler, those larger bodies ran at a fraction of their
// instruction rate.
// Arithmetic is IEEE fp32 FMA, in the order of the plain version (q, then
// p, ascending); the atomics' order changes from run to run, so dF's last
// bits do too.

#include "bulk_copy.cuh"
#include "roi_align_common.cuh"

namespace {

constexpr int TILE = 128;                      // channels an item
constexpr int QUARTERS = TILE / 32;            // warps across a tile, one channel a lane
constexpr int CONSUMERS = 8;                   // consumer warps: QUARTERS x column phases
constexpr int PHASES = CONSUMERS / QUARTERS;   // warps of a quarter, taking columns in turn
constexpr int THREADS = 32 * (CONSUMERS + 1);  // + the producer warp
constexpr int STAGES = 2;                      // slabs in the ring
constexpr int PC_MAX = 16;                     // pooled rows a slab (T[] in registers)
constexpr int ROWS = 8;                        // feature rows a consumer adds at a time
constexpr int BOX_ROWS = 256;                  // rows a TMA box can hold
constexpr int SMEM_MAX = 227 * 1024;           // dynamic shared memory a block can have
constexpr int HDR = 8;                         // ints of an item's header (16-byte multiple)
constexpr unsigned TABLE_LANES = 0xfffffffeu;  // the producer's lanes 1-31

struct Args {
  const float* rois;
  float* out;
  int r_per_img, h, w, c, pooled;
  float scale;
  int tw;            // channels a tile: min(TILE, c)
  int tiles;         // channel tiles a RoI
  int pc;            // pooled rows a slab
  int chunks;        // slabs a (RoI, tile)
  long long items;   // RoIs x tiles x chunks
  int slab_bytes;    // a ring slot's g, 128-byte aligned
  int tab_bytes;     // a ring slot's tables, 128-byte aligned
};

inline int align128(long long n) { return (int)((n + 127) / 128 * 128); }

// A ring slot's tables, in order: the header (roi, ya, xa, wr, p0, kk, c0,
// unused), for each row y (from ya) a record {A[p0 + k + j, y] for j < 3 (0
// past k'), 256 k + k' + 1} of the first and last bin k, k' of the slab
// reaching it (k' < k for none), A [P][H] over rows ya.., B [P][W] over
// columns xa.., the bins' row and column ranges [P][2] each, and for each
// column x the bins q reaching it [W][2] (lo > hi for none).
inline int table_bytes(int p, int h, int w) {
  return align128(4LL * (HDR + 4 * h + p * (h + w) + 4 * p + 2 * w));
}

// each consumer lane's T[k], k < PC_MAX, for the row loop
constexpr int TBUF_BYTES = CONSUMERS * PC_MAX * 32 * 4;

size_t smem_bytes(const Args& a) {
  return (size_t)STAGES * (a.slab_bytes + a.tab_bytes) + TBUF_BYTES + 128 /* alignment */ +
         2 * STAGES * sizeof(uint64_t);
}

// Sets the work plan; cudaErrorInvalidValue for a shape the kernel does not
// take. The slab's pooled rows pc: at most PC_MAX (T[] in registers) and
// BOX_ROWS / P (one TMA box), fewer while the ring does not fit.
int plan(Args& a, int b, int r) {
  const int P = a.pooled;
  if (P < 1 || P > roi::MAX_POOLED || a.h < 1 || a.w < 1 || a.h > roi::MAX_DIM ||
      a.w > roi::MAX_DIM || a.c < 4 || a.c % 4 != 0 || b < 1 || r < 1)
    return (int)cudaErrorInvalidValue;
  a.tw = a.c < TILE ? a.c : TILE;
  a.tiles = (a.c + a.tw - 1) / a.tw;
  a.tab_bytes = table_bytes(P, a.h, a.w);
  int pc = P < PC_MAX ? P : PC_MAX;
  if (pc > BOX_ROWS / P) pc = BOX_ROWS / P;
  auto ring = [&](int rows) {
    return (long long)STAGES * (align128(4LL * rows * P * a.tw) + a.tab_bytes) + TBUF_BYTES +
           128 + 2 * STAGES * 8;
  };
  while (pc > 1 && ring(pc) > SMEM_MAX) --pc;
  if (ring(pc) > SMEM_MAX) return (int)cudaErrorInvalidValue;
  a.pc = pc;
  a.chunks = (P + pc - 1) / pc;
  a.slab_bytes = align128(4LL * pc * P * a.tw);
  a.items = (long long)b * r * a.tiles * a.chunks;
  return 0;
}

__global__ void __launch_bounds__(THREADS, 1)
    roi_align_backward_kernel(const __grid_constant__ CUtensorMap gmap, Args a) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  // 128-byte aligned for TMA, by an offset, so that the compiler still sees
  // shared memory (LDS, not generic loads)
  uint8_t* smem = smem_raw + ((128 - (bulk::smem_u32(smem_raw) & 127)) & 127);
  uint8_t* slabs = smem;                                     // [STAGES][slab_bytes]
  uint8_t* tabs = smem + STAGES * a.slab_bytes;              // [STAGES][tab_bytes]
  float* tbuf = reinterpret_cast<float*>(tabs + STAGES * a.tab_bytes);  // [CONSUMERS][PC_MAX][32]
  uint64_t* full = reinterpret_cast<uint64_t*>(tbuf + CONSUMERS * PC_MAX * 32);
  uint64_t* empty = full + STAGES;

  const int P = a.pooled, H = a.h, W = a.w, C = a.c;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bulk::mbar_init(&full[s], 32);  // the producer's 32 lanes; lane 0 with the bytes
      bulk::mbar_init(&empty[s], CONSUMERS);
    }
    bulk::mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS) {  // the producer
    const uint64_t pol = roi::policy_evict_first();
    const uint32_t box_bytes = (uint32_t)(4 * a.pc * P * a.tw);
    int it = 0;
    for (long long item = blockIdx.x; item < a.items; item += gridDim.x, ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) bulk::mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
      const long long rt = item / a.chunks;
      const int chunk = (int)(item - rt * a.chunks);
      const int roi = (int)(rt / a.tiles), tile = (int)(rt - (long long)roi * a.tiles);
      const int p0 = chunk * a.pc, c0 = tile * a.tw;
      if (lane == 0) {
        bulk::mbar_expect_tx(&full[s], box_bytes);
        bulk::tma_load_3d(slabs + (size_t)s * a.slab_bytes, &gmap, &full[s], c0, p0 * P, roi,
                          pol);
        continue;
      }
      // lanes 1-31: the item's tables
      int* hdr = reinterpret_cast<int*>(tabs + (size_t)s * a.tab_bytes);
      float4* rows = reinterpret_cast<float4*>(hdr + HDR);  // [H]
      float* ad = reinterpret_cast<float*>(rows + H);       // [P][H]
      float* bd = ad + P * H;                            // [P][W]
      int* prange = reinterpret_cast<int*>(bd + P * W);  // [P][2], relative to ya
      int* qrange = prange + 2 * P;                      // [P][2], relative to xa
      int* colq = qrange + 2 * P;                        // [W][2]
      const float* box = a.rois + (size_t)roi * 4;
      const roi::Axis ay(box[1], box[3], a.scale, P, H);
      const roi::Axis ax(box[0], box[2], a.scale, P, W);
      const int ya = ay.first(), xa = ax.first();
      const int hr = ay.last(P) - ya + 1, wr = ax.last(P) - xa + 1;
      const int kk = min(a.pc, P - p0);
      const int l = lane - 1;
      for (int i = l; i < P * (H + W); i += 31) ad[i] = 0.f;  // bd follows ad
      __syncwarp(TABLE_LANES);
      for (int i = l; i < 2 * P; i += 31) {
        if (i < P)
          ay.fill(i, ya, ad + i * H, prange + 2 * i);
        else
          ax.fill(i - P, xa, bd + (i - P) * W, qrange + 2 * (i - P));
      }
      __syncwarp(TABLE_LANES);
      // the bins reaching a column (a row) are consecutive: taps grow with the bin
      for (int i = l; i < wr + hr; i += 31) {
        const bool col = i < wr;
        const int x = col ? i : i - wr;
        const int* rng = col ? qrange : prange;
        int lo = P, hi = -1;
        for (int q = 0; q < P; ++q) {
          if (rng[2 * q] <= x && x <= rng[2 * q + 1]) {
            lo = min(lo, q);
            hi = q;
          }
        }
        if (col) {
          colq[2 * x] = lo;
          colq[2 * x + 1] = hi;
          continue;
        }
        const int k0 = min(max(lo - p0, 0), kk - 1), khi = min(hi - p0, kk - 1);  // the slab's
        const float* arow = ad + p0 * H + x;
        rows[x] = make_float4(k0 <= khi ? arow[k0 * H] : 0.f, k0 < khi ? arow[(k0 + 1) * H] : 0.f,
                              k0 + 1 < khi ? arow[(k0 + 2) * H] : 0.f,
                              __int_as_float(256 * k0 + max(khi, k0 - 1) + 1));
      }
      if (l == 0) {
        hdr[0] = roi, hdr[1] = ya, hdr[2] = xa, hdr[3] = wr, hdr[4] = p0, hdr[5] = kk;
        hdr[6] = c0;
      }
      bulk::mbar_arrive(&full[s]);  // releases this lane's writes
    }
    return;
  }

  // the consumers: warp (phase, quarter) takes channels c0 + 32 quarter + lane
  // of columns x = phase, phase + PHASES, ...
  const int quarter = warp % QUARTERS, phase = warp / QUARTERS;
  const int cl = quarter * 32 + lane;  // channel within the tile
  int it = 0;
  for (long long item = blockIdx.x; item < a.items; item += gridDim.x, ++it) {
    const int s = it % STAGES;
    bulk::mbar_wait(&full[s], (it / STAGES) & 1);
    const int* hdr = reinterpret_cast<const int*>(tabs + (size_t)s * a.tab_bytes);
    const float4* rows = reinterpret_cast<const float4*>(hdr + HDR);
    const float* ad = reinterpret_cast<const float*>(rows + H);
    const float* bd = ad + P * H;
    const int* prange = reinterpret_cast<const int*>(bd + P * W);
    const int* colq = prange + 4 * P;
    const float* slab = reinterpret_cast<const float*>(slabs + (size_t)s * a.slab_bytes);
    const int roi = hdr[0], ya = hdr[1], xa = hdr[2], wr = hdr[3];
    const int p0 = hdr[4], kk = hdr[5], c0 = hdr[6];
    if (cl < a.tw && c0 + cl < C) {
      const int b = roi / a.r_per_img;
      // the rows the slab's bins reach
      const int ylo = prange[2 * p0], yhi = prange[2 * (p0 + kk - 1) + 1];
      float* fout = a.out + ((size_t)(b * H + ya) * W + xa) * C + c0 + cl;  // dF[b, ya, xa]
      const float* arow = ad + p0 * H;
      const size_t row_stride = (size_t)W * C;  // floats from one feature row to the next
      const float* gc = slab + cl;
      const int pstride = P * a.tw;  // floats from one pooled row of the slab to the next
      float* tb = tbuf + warp * PC_MAX * 32 + lane;  // this lane's T[k] at tb[32 k]
      for (int x = phase; x < wr; x += PHASES) {
        const int qlo = colq[2 * x], qhi = colq[2 * x + 1];
        if (qlo > qhi) continue;  // no bin's taps reach column x
        // T[k] = sum_q B[q, x] g[p0 + k, q], the next bin's loads in flight
        // while this bin's FMAs run
        float t[PC_MAX], v[PC_MAX];
        const float* gq = gc + qlo * a.tw;
#pragma unroll
        for (int k = 0; k < PC_MAX; ++k) {
          t[k] = 0.f;
          v[k] = k < kk ? gq[k * pstride] : 0.f;
        }
        for (int q = qlo; q <= qhi; ++q) {
          const float wx = bd[q * W + x];
          const bool more = q < qhi;
          gq += a.tw;
          float nv[PC_MAX];
#pragma unroll
          for (int k = 0; k < PC_MAX; ++k) nv[k] = more && k < kk ? gq[k * pstride] : 0.f;
#pragma unroll
          for (int k = 0; k < PC_MAX; ++k) {
            t[k] = fmaf(wx, v[k], t[k]);
            v[k] = nv[k];
          }
        }
#pragma unroll
        for (int k = 0; k < PC_MAX; ++k)
          if (k < kk) tb[32 * k] = t[k];
        // dF[y, x] += sum over the slab's bins k..k' reaching row y of
        // A[p0 + j, y] T[j], ROWS rows at a time, their loads in flight
        // together: the three first bins' terms from the row's record (a
        // row's bins are at most three but for boxes whose bins are narrower
        // than a third of a cell); rows with more take a second pass
        float* fy = fout + (size_t)x * C + (size_t)ylo * row_stride;  // dF[ya + y0, xa + x]
        for (int y0 = ylo; y0 <= yhi; y0 += ROWS, fy += ROWS * row_stride) {
          float4 rec[ROWS];
#pragma unroll
          for (int u = 0; u < ROWS; ++u) rec[u] = rows[min(y0 + u, yhi)];
          bool more = false;
#pragma unroll
          for (int u = 0; u < ROWS; ++u) {
            const int bins = __float_as_int(rec[u].w);
            const int k0 = bins >> 8, khi = (bins & 255) - 1;  // khi < k0: no bin of the slab
            const int kh = max(khi, k0), k1 = min(k0 + 1, kh), k2 = min(k0 + 2, kh);
            const float acc = fmaf(rec[u].z, tb[32 * k2],
                                   fmaf(rec[u].y, tb[32 * k1], rec[u].x * tb[32 * k0]));
            const bool live = y0 + u <= yhi && khi >= k0;
            more |= live && khi > k0 + 2;
            if (live && khi <= k0 + 2)
              atomicAdd(fy + u * row_stride, acc);  // result unused: a RED
          }
          if (more) {  // unrolled over the rows and by 4 over the bins: loads in flight
#pragma unroll
            for (int u = 0; u < ROWS; ++u) {
              if (y0 + u > yhi) break;
              const int bins = __float_as_int(rows[y0 + u].w);
              const int k0 = bins >> 8, khi = (bins & 255) - 1;
              if (khi <= k0 + 2) continue;
              float acc = 0.f;
#pragma unroll 4
              for (int k = k0; k <= khi; ++k) acc = fmaf(arow[k * H + y0 + u], tb[32 * k], acc);
              atomicAdd(fy + u * row_stride, acc);  // result unused: a RED
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) bulk::mbar_arrive(&empty[s]);
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
  Args a{(const float*)rois, (float*)out, r, h, w, c, pooled, spatial_scale};
  int status = plan(a, b, r);
  if (status) return status;
  if (reinterpret_cast<uintptr_t>(grad) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap gmap;
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)pooled * pooled,
                              (cuuint64_t)b * r};
  const cuuint32_t box[3] = {(cuuint32_t)a.tw, (cuuint32_t)(a.pc * pooled), 1};
  status = bulk::encode_3d(&gmap, grad, dims, box);
  if (status) return status;
  if (!opted) {  // once per process: allow more than 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        roi_align_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long grid = a.items < sms ? a.items : sms;
  roi_align_backward_kernel<<<(unsigned)grid, THREADS, smem_bytes(a), (cudaStream_t)stream>>>(
      gmap, a);
  return (int)cudaGetLastError();
}
