// The Gaussian mmv kernel that csrc/gaussian_mmv.cu replaced when fault C5
// was repaired, as it was, kept to be measured beside it by
// tools/b1_variants.py: all of d summed into one tensor-core accumulator
// over 256-center tiles, which erred by up to 1.3e-5 of the sum of the
// terms' magnitudes on the flagship training's mining rows. Same C entry
// points as then (odt_split_tf32, odt_mmv_grouped); its own TMA helpers.
//
// Grouped Gaussian-kernel matrix-vector product on Hopper: 3xTF32 on the
// tensor cores (wgmma), operands brought in by TMA.
//
// Replaces: online_detection_tpu/ops/gaussian_mmv.py::mmv_pallas (body
// _mmv_kernel). Computes, for every group g with center set s = set_idx[g],
//
//   out[g, n] = sum_m exp(-max(|x_gn|^2 + |c_sm|^2 - 2 x_gn.c_sm, 0) / (2 s^2))
//               * v[s, m]
//
// One launch serves every caller: the RPN's 15 anchor classifiers and the
// detector's 21 class classifiers (x shared by every group), the mask
// head's own-class scores (one group per RoI, set_idx = label - 1: centers
// are picked by index, never copied), and the minibootstrap's mining passes
// (one group per class of a chunk, x per group).
//
// Precision: the cross term cancels against the norms, so it must be fp32
// accurate (a single reduced-precision pass cost det mAP 0.92 -> 0.50 on
// the TPU). Each operand is split as hi = tf32_rna(a), lo = tf32_rna(a - hi)
// and x.c ~ x_hi.c_hi + x_hi.c_lo + x_lo.c_hi (lo.lo, ~2^-22 relative, is
// dropped), each product exact in the tensor cores and summed in fp32.
//
// What bounds it on an H100: operations, at the 3xTF32 rate (495 TFLOP/s
// dense TF32 / 3 = 165 TFLOP/s): the RPN call is 2*15*15200*1000*1025 ~
// 4.7e11 FLOP against ~1e8 bytes of operands.
//
// Design:
// - split_tf32_kernel splits the centers once per call into c_hi and c_lo
//   [S, M, d] (B operands must come from shared memory) and sums their
//   squared norms on the way. x is split in registers: it is read at 4
//   bytes per element and never written back.
// - mmv_tf32x3_kernel: a block owns (group, 128 rows) and walks the center
//   set in 256-center tiles (wgmma N = 256: each pass over the centers
//   re-reads the block's x rows, so wide tiles re-read x fewer times). The
//   grid is group-major, so one group's split centers stay in L2 while its
//   row tiles run. A producer warp keeps a ring of 2 stages in flight; a
//   stage is 32 columns of d (one 128-byte swizzle row): x [128, 32], c_hi
//   and c_lo [256, 32], 80 KB, loaded by TMA into 128-byte-swizzled shared
//   memory. Two consumer warpgroups own 64 rows each and share every center
//   tile; per stage a consumer loads its x fragment from shared memory,
//   splits it and issues 4 k-steps x 3 wgmma.m64n256k8 (A from registers),
//   then waits for them and releases the stage.
// - Epilogue per center tile, on the wgmma accumulator layout (a thread
//   holds 2 rows x 64 columns): sq = |x|^2 + |c|^2 - 2 acc, max(sq, 0),
//   exp, times v, summed per row in registers. |x|^2 is summed in fp32
//   from the x values the consumers load for the products (the 4 lanes of
//   a quad hold all of d), so x is read once; |c|^2 and v are staged in
//   shared memory, v = 0 past m. After the last tile the quad reduces with
//   shuffles and each output row is written once: the [N, M] kernel block
//   never reaches device memory. Tiles may read into the next group's rows
//   or the next set's centers (finite values) and TMA fills zeros past a
//   tensor's end, so masking is exact with no inf * 0.
// - Tried on the card and not kept, each slower at the main-path calls: a
//   64-row tile (one consumer warpgroup; the mask head's 196-row groups pad
//   to 256 rows with either tile); a ring of 5 stages of 16 columns; one
//   wgmma group left in flight across stages (ptxas serialises it); and
//   clusters of 2 CTAs multicasting the center tiles (the cross-CTA
//   handshake costs more than the L2 reads it saves).
// - Budget (nvcc -Xptxas -v, sm_90a; the chip smoke prints it): 168
//   registers at launch, 0 spills; the consumers are raised to 232 and the
//   producer lowered to 40 with setmaxnreg; 173,088 bytes of dynamic shared
//   memory, so one block per SM.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;   // floats of d per stage: one 128-byte swizzle row
constexpr int BM = 256;  // centers per tile: wgmma N

constexpr int NWG = 2;   // consumer warpgroups, 64 rows each
constexpr int BN = 64 * NWG;  // x rows per block
constexpr int STAGES = 2;
constexpr int X_BYTES = BN * BK * 4;
constexpr int C_BYTES = BM * BK * 4;
constexpr int STAGE_BYTES = X_BYTES + 2 * C_BYTES;
constexpr int THREADS = 128 * (NWG + 1);  // + the producer warpgroup
constexpr int TAB_BYTES = NWG * 2 * 2 * BM * 4;  // [wg][tile parity][|c|^2, v][BM]
constexpr int SMEM = STAGES * STAGE_BYTES + TAB_BYTES + 2 * STAGES * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzle:
// 8-row core groups 1024 bytes apart. The start address advances by 32
// bytes per k-step of 8 tf32 (added to the low field by the caller).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint32_t addr = smem_u32(tile);
  uint64_t desc = (uint64_t)((addr & 0x3FFFF) >> 4);
  desc |= (uint64_t)1 << 16;           // leading byte offset: unused for swizzled K-major
  desc |= (uint64_t)(1024 >> 4) << 32;  // stride byte offset
  desc |= (uint64_t)1 << 62;           // 128-byte swizzle
  return desc;
}

__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(a));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(a - __uint_as_float(hi)));
}

__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += a[64 x 8] (registers, tf32) * b[256 x 8]^T (shared, tf32).
// A thread holds rows 16*warp + lane/4 (+8) of a at columns lane%4 (+4),
// and of d at columns 8j + 2*(lane%4) (+1) in d[4j .. 4j+3].
__device__ __forceinline__ void wgmma_tf32(float (&d)[128], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"
      " %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124,"
      " %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float gauss(float norms, float acc, float neg_scale) {
  return exp2f(fmaxf(fmaf(-2.f, acc, norms), 0.f) * neg_scale);
}

// One warp per row of d values: hi and lo, and the row's squared norm
// (fp32, lane-strided partial sums reduced by shuffles).
__global__ void __launch_bounds__(256)
split_tf32_kernel(const float4* __restrict__ src, float4* __restrict__ hi,
                  float4* __restrict__ lo, float* __restrict__ sq, long long rows, int d4) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  for (long long r = blockIdx.x * (long long)(blockDim.x / 32) + threadIdx.x / 32; r < rows;
       r += warps) {
    float acc = 0.f;
    for (int k = lane; k < d4; k += 32) {
      const long long i = r * d4 + k;
      const float4 a = src[i];
      uint4 h, l;
      split_tf32(a.x, h.x, l.x);
      split_tf32(a.y, h.y, l.y);
      split_tf32(a.z, h.z, l.z);
      split_tf32(a.w, h.w, l.w);
      hi[i] = *reinterpret_cast<const float4*>(&h);
      lo[i] = *reinterpret_cast<const float4*>(&l);
      acc = fmaf(a.w, a.w, fmaf(a.z, a.z, fmaf(a.y, a.y, fmaf(a.x, a.x, acc))));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) sq[r] = acc;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
mmv_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_hi,
                  const __grid_constant__ CUtensorMap tm_lo, const float* __restrict__ cs,
                  const float* __restrict__ v, const int* __restrict__ set_idx,
                  float* __restrict__ out, long long x_grows, int n, int m, int d,
                  float neg_scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 128-byte swizzled tiles need 1024-byte aligned shared addresses
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* tab = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES + TAB_BYTES);
  uint64_t* empty = full + STAGES;

  const int g = blockIdx.y;
  const int n0 = blockIdx.x * BN;
  const int s = set_idx[g];
  const int wg = threadIdx.x / 128;
  const int tiles = (m + BM - 1) / BM;
  const int kblocks = (d + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * NWG);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {  // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == NWG * 128) {
      const int xrow = (int)(g * x_grows) + n0;
      const int crow = s * m;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < tiles; ++t) {
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          unsigned char* base = smem + stage * STAGE_BYTES;
          tma_load_2d(base, &tm_x, &full[stage], kb * BK, xrow);
          tma_load_2d(base + X_BYTES, &tm_hi, &full[stage], kb * BK, crow + t * BM);
          tma_load_2d(base + X_BYTES + C_BYTES, &tm_lo, &full[stage], kb * BK,
                      crow + t * BM);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: tile rows 64*wg .. 64*wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int q = lane & 3;
    const int rl = 64 * wg + 16 * (tid / 32) + (lane >> 2);  // this thread's rows: rl, rl + 8
    const int sw = rl & 7;                                   // swizzle phase of both rows
    const int r0 = n0 + rl, r1 = r0 + 8;
    const float* csg = cs + (long long)s * m;
    const float* vg = v + (long long)s * m;
    float* my_tab = tab + wg * 4 * BM;

    float acc[128];
    float p0 = 0.f, p1 = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < tiles; ++t) {
      float* tcs = my_tab + (t & 1) * 2 * BM;
      float* tv = tcs + BM;
      for (int i = tid; i < BM; i += 128) {
        const int col = t * BM + i;
        tcs[i] = col < m ? csg[col] : 0.f;
        tv[i] = col < m ? vg[col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      fence_acc(acc);
      float xs0 = 0.f, xs1 = 0.f;  // |x|^2 of rows rl and rl + 8, over this lane's columns

      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(&full[stage], phase);
        const unsigned char* base = smem + stage * STAGE_BYTES;
        const float* xt = reinterpret_cast<const float*>(base);
        const uint64_t dhi = sw128_desc(base + X_BYTES);
        const uint64_t dlo = sw128_desc(base + X_BYTES + C_BYTES);
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          // 16-byte chunk j of row r sits at chunk j ^ (r % 8)
          const int c0 = (((2 * ks) ^ sw) << 2) + q;
          const int c1 = (((2 * ks + 1) ^ sw) << 2) + q;
          const float a0 = xt[rl * BK + c0], a1 = xt[(rl + 8) * BK + c0];
          const float a2 = xt[rl * BK + c1], a3 = xt[(rl + 8) * BK + c1];
          xs0 = fmaf(a2, a2, fmaf(a0, a0, xs0));
          xs1 = fmaf(a3, a3, fmaf(a1, a1, xs1));
          split_tf32(a0, ah[ks][0], al[ks][0]);
          split_tf32(a1, ah[ks][1], al[ks][1]);
          split_tf32(a2, ah[ks][2], al[ks][2]);
          split_tf32(a3, ah[ks][3], al[ks][3]);
        }
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {  // small terms first
          wgmma_tf32(acc, al[ks], dhi + 2 * ks);
          wgmma_tf32(acc, ah[ks], dlo + 2 * ks);
          wgmma_tf32(acc, ah[ks], dhi + 2 * ks);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc);
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // the 4 lanes of a quad hold the same two rows and together all of d;
      // the sum is the same on every tile and every lane of the quad
      xs0 += __shfl_xor_sync(0xffffffffu, xs0, 1);
      xs0 += __shfl_xor_sync(0xffffffffu, xs0, 2);
      xs1 += __shfl_xor_sync(0xffffffffu, xs1, 1);
      xs1 += __shfl_xor_sync(0xffffffffu, xs1, 2);
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");  // tables written
      const float2* c2 = reinterpret_cast<const float2*>(tcs);
      const float2* v2 = reinterpret_cast<const float2*>(tv);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float2 cc = c2[4 * j + q];
        const float2 vv = v2[4 * j + q];
        p0 = fmaf(gauss(xs0 + cc.x, acc[4 * j + 0], neg_scale), vv.x, p0);
        p0 = fmaf(gauss(xs0 + cc.y, acc[4 * j + 1], neg_scale), vv.y, p0);
        p1 = fmaf(gauss(xs1 + cc.x, acc[4 * j + 2], neg_scale), vv.x, p1);
        p1 = fmaf(gauss(xs1 + cc.y, acc[4 * j + 3], neg_scale), vv.y, p1);
      }
    }

    p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
    p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
    if (q == 0) {
      if (r0 < n) out[(long long)g * n + r0] = p0;
      if (r1 < n) out[(long long)g * n + r1] = p1;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: its address comes from the
// runtime's entry-point query, so the library links no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A [rows, d] fp32 row-major tensor, read in [box_rows, 32] boxes into
// 128-byte-swizzled shared memory; zeros past its end.
int encode(CUtensorMap* map, const void* base, long long rows, int d, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// src: [rows, d] fp32 (d % 4 == 0, 16-byte aligned) -> hi = tf32_rna(src),
// lo = tf32_rna(src - hi), each [rows, d], and sq: the rows' squared norms
// [rows]; launches on `stream`.
extern "C" int odt_split_tf32(const void* src, void* hi, void* lo, void* sq, long long rows,
                              int d, void* stream) {
  if (rows < 0 || d < 4 || d % 4 != 0 || !aligned16(src) || !aligned16(hi) || !aligned16(lo))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  long long blocks = (rows + 7) / 8;  // 8 warps a block, one row each
  if (blocks > 132 * 16) blocks = 132 * 16;
  split_tf32_kernel<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)src, (float4*)hi, (float4*)lo, (float*)sq, rows, d / 4);
  return (int)cudaGetLastError();
}

// x: [x_rows, d], group g's rows start at g * x_grows (x_grows = n, or 0
// when every group shares x); c_hi, c_lo: the split centers [c_rows =
// S * m, d]; cs: their
// squared norms [S, m]; v: [S, m]; set_idx: [groups]; out: [groups, n].
// All fp32 (set_idx int32) and contiguous, d % 4 == 0, x and the centers
// 16-byte aligned (else cudaErrorInvalidValue); launches on `stream`.
extern "C" int odt_mmv_grouped(const void* x, long long x_rows, long long x_grows,
                               const void* c_hi,
                               const void* c_lo, long long c_rows, const void* cs,
                               const void* v, const void* set_idx, void* out, int groups,
                               int n, int m, int d, float sigma, void* stream) {
  if (groups < 1 || groups > 65535 || n < 1 || m < 1 || d < 1 || d % 4 != 0 ||
      x_rows < 1 || x_rows >= (1LL << 31) || c_rows < 1 || c_rows >= (1LL << 31) ||
      !aligned16(x) || !aligned16(c_hi) || !aligned16(c_lo))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, thi, tlo;
  int e = encode(&tx, x, x_rows, d, BN);
  if (e == 0) e = encode(&thi, c_hi, c_rows, d, BM);
  if (e == 0) e = encode(&tlo, c_lo, c_rows, d, BM);
  if (e != 0) return e;
  const float neg_scale = (float)(-1.4426950408889634 / (2.0 * (double)sigma * (double)sigma));
  const cudaError_t e2 =
      cudaFuncSetAttribute(mmv_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e2 != cudaSuccess) return (int)e2;
  const dim3 grid((n + BN - 1) / BN, groups);  // x fastest: group-major order
  mmv_tf32x3_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      tx, thi, tlo, (const float*)cs, (const float*)v,
      (const int*)set_idx, (float*)out, x_grows, n, m, d, neg_scale);
  return (int)cudaGetLastError();
}
