// Haplotag read scoring for Hopper (sm_90a) on tensor cores: the CUDA
// counterpart of the Pallas kernels in duet_tpu/ops/pallas_haplotag.py
//   ::_score_kernel (:92), launched by haplotag_score_batch_pallas (:227)
//       with one rhs per task, and by phase_and_tag_fused (:183) with one
//       rhs shared by every row tile (n_tasks = 1), and
//   ::_kernel (:37), launched by haplotag_score_pallas (:271): the same
//       math on an aw and |aw| computed outside the kernel.
//
// What it computes.  n_tasks independent scoring tasks, each a stack of
// rows_per_task reads over S het sites with its own (S, K) right-hand side
// rhs = [phase | informative | block one-hot ...].  Per read row:
//   aw      = bf16(allele * weight)   (FusedAw: formed on chip, never
//             stored), or the given bf16 aw with its given |aw| (GivenAw)
//   signed  = sum_s aw[s]  * rhs[s, 0]
//   total   = sum_s |aw[s]| * rhs[s, 1]
//   blockw  = sum_s |aw[s]| * rhs[s, 2 + b]          for b < n_blocks
//   hap     = total > 0 && signed != 0 ? (signed > 0 ? 1 : 2) : 0
//   pc      = hap ? clip(rint(10 * |signed|), 1, 8100) : -1
//   best    = the FIRST b with the largest blockw (lowest index on ties)
// Outputs are three int32 vectors; the TPU kernel's 128-lane packed tile
// was a TPU layout choice and is not carried over.  Every product is an
// integer (|aw| <= 40 for quality weights, rhs in {-1, 0, 1}) and every
// partial sum is an integer below 2^24, so bf16 tensor-core products with
// fp32 accumulation are exact in any order: the results are bit-identical
// to the plain torch versions (ops.haplotag).
//
// What bounds it.  Each launch must read its lhs once; the products are
// few against those bytes.
//   - Shared rhs (bench shape R = 32768, S = 4096, K = 66): int8 alleles
//     134.2 MB + bf16 weights 268.4 MB + rhs 0.54 MB + 0.39 MB of int32
//     out = 403.6 MB, 0.120 ms at 3.35 TB/s; 2*R*S*K = 17.7 GFLOP, 0.018
//     ms on bf16 tensor cores.  Memory-bound.
//   - GivenAw (bench shape): two bf16 (R, S) matrices, 537.8 MB, 0.161 ms.
//   - Batched (pipeline shape, 16 tasks x 256 rows, S = 2304, K = 128):
//     9.44 + 18.87 MB of lhs, 9.44 MB of rhs, 0.05 MB out: 37.8 MB,
//     11.3 us dense; the windows are ~1-2% nonzero.
//
// What the design does about it.
//   - Products on tensor cores: mma.sync m16n8k16 bf16 -> fp32.  A warp
//     owns 16 rows; the rhs is walked in slabs of at most 128 columns, each
//     slab as n8 tiles (K = 66 takes 9 tiles, 72 columns, not 128).  Column
//     0 (signed) takes aw and every other column |aw|, so the first tile is
//     multiplied once more with the aw fragment: one extra mma a k-step.
//     |aw| is a bit-clear of the packed bf16 pair.  wgmma/TMA would buy
//     nothing here: the tensor cores idle at a fraction of their peak while
//     the loads run.
//   - Loads at memory speed: 16-byte cp.async.cg copies of the lhs (int8
//     alleles + bf16 weights, or aw + |aw|) and of the rhs chunk into a
//     ring of 2 or 3 shared-memory stages of 64 sites, so the next 1 or 2
//     chunks are in flight while the tensor cores work on this one.  A
//     stage takes 64 bytes of alleles and 128 of weights from each row:
//     whole 128-byte lines of the weights.  On the H100 the bench-shape
//     launches ran faster with these stages than with 32-site stages,
//     while deeper rings of 32-site stages did not help (PERF.md).  aw = bf16(a * w) is formed
//     while the A fragments are built, rounded like the reference's bf16
//     multiply.  Rows are padded in shared memory so that the fragment
//     reads and the ldmatrix.trans reads of the rhs hit distinct banks.
//     Shapes whose rows are not 16-byte aligned (S % 16 != 0, or K % 8 != 0
//     for the rhs) take a plain element-wise staging path instead, which is
//     right at any shape and slower; the port's callers build aligned rhs.
//   - 128 rows per CTA (8 warps, 2 stages), so each CTA re-reads the rhs
//     from L2 for 4x as many rows as a 32-row tile did; the bench shape
//     still has 256 CTAs for 132 SMs.  A grid of 128-row CTAs that would not
//     fill the SMs takes 64-row CTAs (4 warps, 3 stages) instead: the
//     pipeline's 16 x 256-row launch runs 64 CTAs, not 32.
//   - The zero skip is warp-uniform: a k-step whose 16 x 16 allele block
//     (aw and |aw| for GivenAw) is all zero in the warp's rows issues no
//     ldmatrix and no mma.  The pipeline's windows are position-sorted
//     reads, so most k-steps of a warp are empty there.  The lhs and rhs
//     chunks are still copied: the copies are issued a stage or two before
//     the allele block is seen.
//   - Registers: __launch_bounds__(32 * W, 16 / W) caps a thread at 128, so
//     that two 8-warp (four 4-warp) CTAs fit an SM; the accumulators of a
//     128-column slab take 68.  What ptxas gives each instantiation
//     (-Xptxas -v, printed by chip_smoke.py) is recorded in PERF.md.
//
// Built by nvcc into a shared library with a plain C interface
// (duet_tpu_torch/ops/cuda_build.py); each launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// A CTA of W warps owns 16 * W read rows and runs 32 * W threads.  The two
// launch shapes (see launch()): 128-row CTAs with a 2-stage ring, and 64-row
// CTAs with a 3-stage ring for grids too small to fill the SMs.
constexpr int BIG_WARPS = 8, BIG_STAGES = 2;
constexpr int SMALL_WARPS = 4, SMALL_STAGES = 3;
constexpr int SK = 64;                       // sites per shared-memory stage
constexpr int AL_VECS = SK / 16;             // 16-byte copies a row: alleles
constexpr int BF_VECS = SK / 8;              //   and bf16
constexpr int NT_MAX = 16;                   // n8 tiles per slab: 128 columns
constexpr int SLAB = NT_MAX * 8;
constexpr float PC_PER_MARGIN = 10.0f;
constexpr float PC_MAX = 8100.0f;

// shared-memory row strides in bytes, padded by 16 so that the 8 row
// groups of a fragment read land on distinct banks
constexpr int AL_STRIDE = SK + 16;           // int8 alleles
constexpr int BF_STRIDE = SK * 2 + 16;       // bf16 rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two n8 B tiles (columns n0..n0+15) of a row-major [k][n] bf16 stage
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&b)[4],
                                                  const void* row_addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_u32(row_addr)));
}

// bf16 pair (a0 * w0, a1 * w1) from two int8 alleles and a bf16 weight
// pair, each product rounded to bf16 like the reference's bf16 multiply
__device__ __forceinline__ uint32_t aw_pair(uint32_t a2, uint32_t w2) {
  const float a0 = (float)(int8_t)(a2 & 0xffu);
  const float a1 = (float)(int8_t)((a2 >> 8) & 0xffu);
  const float w0 = __uint_as_float(w2 << 16);
  const float w1 = __uint_as_float(w2 & 0xffff0000u);
  const __nv_bfloat162 p = __floats2bfloat162_rn(a0 * w0, a1 * w1);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Where a stage's lhs lives and how its A fragments are built.  `vec`
// selects the 16-byte cp.async path (rows 16-byte aligned) over the
// element-wise one.
struct FusedAw {                             // _score_kernel
  const int8_t* alleles;
  const __nv_bfloat16* weights;
  __host__ __device__ static constexpr int stage_bytes(int tile_m) {
    return tile_m * (AL_STRIDE + BF_STRIDE);
  }

  template <int TILE_M>
  __device__ void stage(uint8_t* st, int64_t row0, int n_rows, int S, int s0,
                        bool vec) const {
    constexpr int THREADS = 2 * TILE_M;
    uint8_t* al = st;
    uint8_t* wt = st + TILE_M * AL_STRIDE;
    if (vec) {
#pragma unroll
      for (int i = 0; i < TILE_M * AL_VECS / THREADS; ++i) {  // alleles
        const int idx = threadIdx.x + i * THREADS;
        const int r = idx / AL_VECS, v = idx % AL_VECS;
        const int s = s0 + 16 * v;
        const bool ok = r < n_rows && s < S;
        cp_async16(al + r * AL_STRIDE + 16 * v,
                   ok ? alleles + (row0 + r) * S + s : alleles, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < TILE_M * BF_VECS / THREADS; ++i) {  // weights
        const int idx = threadIdx.x + i * THREADS;
        const int r = idx / BF_VECS, v = idx % BF_VECS;
        const int s = s0 + 8 * v;
        const bool ok = r < n_rows && s < S;
        cp_async16(wt + r * BF_STRIDE + 16 * v,
                   ok ? weights + (row0 + r) * S + s : weights, ok ? 16 : 0);
      }
      return;
    }
    for (int idx = threadIdx.x; idx < TILE_M * SK; idx += THREADS) {
      const int r = idx / SK, k = idx % SK;
      const bool ok = r < n_rows && s0 + k < S;
      const int64_t off = (row0 + r) * S + s0 + k;
      al[r * AL_STRIDE + k] = ok ? (uint8_t)alleles[off] : 0;
      reinterpret_cast<__nv_bfloat16*>(wt + r * BF_STRIDE)[k] =
          ok ? weights[off] : __float2bfloat16(0.0f);
    }
  }

  // the A fragments (aw, |aw|) of the 16 x 16 block at rows r0.. and
  // k-column kb of the stage; false when the warp's block is all zero
  template <int TILE_M>
  __device__ bool fragments(const uint8_t* st, int r0, int kb,
                            uint32_t (&aw)[4], uint32_t (&ab)[4]) const {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint8_t* al = st;
    const uint8_t* wt = st + TILE_M * AL_STRIDE;
    uint32_t a2[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // q: (row g | g+8) x (k 2t | 2t+8)
      const int r = r0 + g + 8 * (q & 1);
      const int k = kb + 2 * t + 8 * (q >> 1);
      a2[q] = *reinterpret_cast<const uint16_t*>(al + r * AL_STRIDE + k);
    }
    if (!__any_sync(0xffffffffu, (a2[0] | a2[1] | a2[2] | a2[3]) != 0u))
      return false;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + g + 8 * (q & 1);
      const int k = kb + 2 * t + 8 * (q >> 1);
      const uint32_t w2 =
          *reinterpret_cast<const uint32_t*>(wt + r * BF_STRIDE + 2 * k);
      aw[q] = aw_pair(a2[q], w2);
      ab[q] = aw[q] & 0x7fff7fffu;
    }
    return true;
  }
};

struct GivenAw {                             // _kernel
  const __nv_bfloat16* aw;
  const __nv_bfloat16* abs_aw;
  __host__ __device__ static constexpr int stage_bytes(int tile_m) {
    return tile_m * 2 * BF_STRIDE;
  }

  template <int TILE_M>
  __device__ void stage(uint8_t* st, int64_t row0, int n_rows, int S, int s0,
                        bool vec) const {
    constexpr int THREADS = 2 * TILE_M;
    uint8_t* dst[2] = {st, st + TILE_M * BF_STRIDE};
    const __nv_bfloat16* src[2] = {aw, abs_aw};
    if (vec) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {  // aw, then |aw|
#pragma unroll
        for (int i = 0; i < TILE_M * BF_VECS / THREADS; ++i) {
          const int idx = threadIdx.x + i * THREADS;
          const int r = idx / BF_VECS, v = idx % BF_VECS;
          const int s = s0 + 8 * v;
          const bool ok = r < n_rows && s < S;
          cp_async16(dst[m] + r * BF_STRIDE + 16 * v,
                     ok ? src[m] + (row0 + r) * S + s : src[m], ok ? 16 : 0);
        }
      }
      return;
    }
    for (int idx = threadIdx.x; idx < TILE_M * SK; idx += THREADS) {
      const int r = idx / SK, k = idx % SK;
      const bool ok = r < n_rows && s0 + k < S;
      const int64_t off = (row0 + r) * S + s0 + k;
#pragma unroll
      for (int m = 0; m < 2; ++m)
        reinterpret_cast<__nv_bfloat16*>(dst[m] + r * BF_STRIDE)[k] =
            ok ? src[m][off] : __float2bfloat16(0.0f);
    }
  }

  template <int TILE_M>
  __device__ bool fragments(const uint8_t* st, int r0, int kb,
                            uint32_t (&a)[4], uint32_t (&ab)[4]) const {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    uint32_t nz = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + g + 8 * (q & 1);
      const int off = r * BF_STRIDE + 2 * (kb + 2 * t + 8 * (q >> 1));
      a[q] = *reinterpret_cast<const uint32_t*>(st + off);
      ab[q] = *reinterpret_cast<const uint32_t*>(st + TILE_M * BF_STRIDE +
                                                 off);
      nz |= a[q] | ab[q];
    }
    return __any_sync(0xffffffffu, nz != 0u);
  }
};

// rhs chunk [SK sites][slab columns] of a stage, row stride rh_units * 16
// bytes (an odd count of 16-byte units: conflict-free ldmatrix rows)
template <int THREADS>
__device__ void stage_rhs(uint8_t* rs, const __nv_bfloat16* rhs_t, int S,
                          int K, int s0, int c0, int nt, int rh_units,
                          bool vec) {
  if (vec) {  // K % 8 == 0: every 8-column group is one 16-byte copy
    for (int idx = threadIdx.x; idx < SK * nt; idx += THREADS) {
      const int k = idx / nt, v = idx % nt;
      const bool ok = s0 + k < S;
      cp_async16(rs + k * rh_units * 16 + 16 * v,
                 ok ? rhs_t + (int64_t)(s0 + k) * K + c0 + 8 * v : rhs_t,
                 ok ? 16 : 0);
    }
    return;
  }
  const int w = nt * 8;
  for (int idx = threadIdx.x; idx < SK * w; idx += THREADS) {
    const int k = idx / w, c = idx % w;
    const bool ok = s0 + k < S && c0 + c < K;
    reinterpret_cast<__nv_bfloat16*>(rs + k * rh_units * 16)[c] =
        ok ? rhs_t[(int64_t)(s0 + k) * K + c0 + c] : __float2bfloat16(0.0f);
  }
}

template <class Lhs, int WARPS, int STAGES>
__global__ void __launch_bounds__(WARPS * 32, 16 / WARPS)
haplotag_score_kernel(Lhs lhs, const __nv_bfloat16* __restrict__ rhs,
                      int32_t* __restrict__ hap, int32_t* __restrict__ pc,
                      int32_t* __restrict__ best, int rows_per_task, int S,
                      int K, int n_blocks, int rh_units, bool lhs_vec,
                      bool rhs_vec) {
  constexpr int THREADS = WARPS * 32;
  constexpr int TILE_M = WARPS * 16;
  constexpr int LHS_BYTES = Lhs::stage_bytes(TILE_M);
  extern __shared__ __align__(16) uint8_t smem[];
  const int stage_bytes = LHS_BYTES + SK * rh_units * 16;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;                              // warp's rows
  const int tile_row0 = blockIdx.x * TILE_M;             // within the task
  const int n_rows = min(TILE_M, rows_per_task - tile_row0);
  const int64_t row0 = (int64_t)blockIdx.y * rows_per_task + tile_row0;
  const __nv_bfloat16* rhs_t = rhs + (int64_t)blockIdx.y * S * K;
  const int n_chunks = (S + SK - 1) / SK;

  // per thread: rows g and g + 8 of the warp; only t == 0 writes them
  float sgn[2] = {0.0f, 0.0f}, tot[2] = {0.0f, 0.0f};
  float best_v[2] = {-INFINITY, -INFINITY};
  int best_b[2] = {0x7fffffff, 0x7fffffff};

  for (int c0 = 0; c0 < K; c0 += SLAB) {
    const int nt = min((K - c0 + 7) / 8, NT_MAX);       // n8 tiles here
    const bool first = c0 == 0;
    float acc[NT_MAX][4];
    float acc_s[4] = {0.0f, 0.0f, 0.0f, 0.0f};          // signed: aw x tile 0
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

    auto issue = [&](int chunk) {
      if (chunk < n_chunks) {
        uint8_t* st = smem + (chunk % STAGES) * stage_bytes;
        lhs.template stage<TILE_M>(st, row0, n_rows, S, chunk * SK, lhs_vec);
        stage_rhs<THREADS>(st + LHS_BYTES, rhs_t, S, K, chunk * SK, c0, nt,
                  rh_units, rhs_vec);
      }
      cp_async_commit();  // one group per chunk, empty past the end
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) issue(i);

    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of `chunk` landed
      __syncthreads();              // everyone's; stage chunk-1 is free
      issue(chunk + STAGES - 1);
      const uint8_t* st = smem + (chunk % STAGES) * stage_bytes;
      const uint8_t* rs = st + LHS_BYTES;
#pragma unroll
      for (int kb = 0; kb < SK; kb += 16) {
        uint32_t aw[4], ab[4];
        if (!lhs.template fragments<TILE_M>(st, r0, kb, aw, ab))
          continue;  // warp-uniform skip
        // ldmatrix rows: lanes 0-15 -> k rows kb..kb+15 of tile n, lanes
        // 16-31 the same rows of tile n + 1
        const uint8_t* bp =
            rs + (kb + (lane & 15)) * rh_units * 16 + (lane >> 4) * 16;
#pragma unroll
        for (int jp = 0; jp < NT_MAX / 2; ++jp) {
          if (2 * jp < nt) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, bp + jp * 32);
            if (jp == 0 && first) mma_bf16(acc_s, aw, b[0], b[1]);
            mma_bf16(acc[2 * jp], ab, b[0], b[1]);
            if (2 * jp + 1 < nt) mma_bf16(acc[2 * jp + 1], ab, b[2], b[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is reused by the next slab

    // slab epilogue: the thread holds columns c0 + 8j + 2t (+1) of rows g
    // (acc[.][0..1]) and g + 8 (acc[.][2..3]); blocks start at column 2
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float bv = -INFINITY;
      int bc = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < NT_MAX; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int blk = c0 + 8 * j + 2 * t + e - 2;
          // columns rise with (j, e), so a strict '>' keeps the first max
          if (j < nt && blk >= 0 && blk < n_blocks && acc[j][2 * h + e] > bv) {
            bv = acc[j][2 * h + e];
            bc = blk;
          }
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the row's 4 lanes
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
        if (ov > bv || (ov == bv && oc < bc)) {
          bv = ov;
          bc = oc;
        }
      }
      // later slabs hold higher block indices: a tie keeps the earlier one
      if (bv > best_v[h]) {
        best_v[h] = bv;
        best_b[h] = bc;
      }
      if (first) {  // lane t == 0 holds columns 0 (signed) and 1 (total)
        sgn[h] = acc_s[2 * h];
        tot[h] = acc[0][2 * h + 1];
      }
    }
  }

  if (t != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r < n_rows) {
      const bool tagged = (tot[h] > 0.0f) && (sgn[h] != 0.0f);
      float m = rintf(PC_PER_MARGIN * fabsf(sgn[h]));
      m = fminf(fmaxf(m, 1.0f), PC_MAX);
      const int64_t o = row0 + r;
      hap[o] = tagged ? (sgn[h] > 0.0f ? 1 : 2) : 0;
      pc[o] = tagged ? (int32_t)m : -1;
      best[o] = best_b[h];
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

int rh_units_for(int K) {
  // ldmatrix reads n8 tiles in pairs; an odd unit count keeps its 8 row
  // addresses on distinct banks
  const int nt_max = (K + 7) / 8 < NT_MAX ? (K + 7) / 8 : NT_MAX;
  return ((nt_max + 1) & ~1) + 1;
}

bool big_tiles(int n_tasks, int rows_per_task, int n_sm) {
  return (long long)((rows_per_task + 127) / 128) * n_tasks >= n_sm;
}

// The launch shape: 128-row CTAs (8 warps, 3 stages) while they alone fill
// the SMs; below that 64-row CTAs (4 warps, 4 stages), which give a small
// grid twice the CTAs (the pipeline's 16 x 256-row launch: 64 instead of 32).
template <class Lhs, int WARPS, int STAGES>
cudaError_t launch_as(const Lhs& lhs, const void* rhs, void* hap, void* pc,
                      void* best, int n_tasks, int rows_per_task, int S,
                      int K, int n_blocks, int rh_units, bool lhs_vec,
                      bool rhs_vec, int dev, cudaStream_t stream) {
  constexpr int TILE_M = WARPS * 16;
  constexpr int LHS_BYTES = Lhs::stage_bytes(TILE_M);
  auto kernel = haplotag_score_kernel<Lhs, WARPS, STAGES>;
  // once per device: room for the widest slab (NT_MAX + 1 units)
  static bool smem_set[64];
  if (!smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        STAGES * (LHS_BYTES + SK * (NT_MAX + 1) * 16));
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const int smem = STAGES * (LHS_BYTES + SK * rh_units * 16);
  const dim3 grid((rows_per_task + TILE_M - 1) / TILE_M, n_tasks);
  kernel<<<grid, WARPS * 32, smem, stream>>>(
      lhs, (const __nv_bfloat16*)rhs, (int32_t*)hap, (int32_t*)pc,
      (int32_t*)best, rows_per_task, S, K, n_blocks, rh_units, lhs_vec,
      rhs_vec);
  return cudaGetLastError();
}

template <class Lhs>
int launch(Lhs lhs, bool lhs_aligned, const void* rhs, void* hap, void* pc,
           void* best, int n_tasks, int rows_per_task, int S, int K,
           int n_blocks, void* stream) {
  if (n_tasks < 1 || n_tasks > 65535 || rows_per_task < 1 || S < 1 ||
      K < 3 || n_blocks < 1 || n_blocks > K - 2)
    return (int)cudaErrorInvalidValue;
  static int n_sm[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (n_sm[dev] == 0) {
    err = cudaDeviceGetAttribute(&n_sm[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int rh_units = rh_units_for(K);
  const bool lhs_vec = lhs_aligned && S % 16 == 0;
  const bool rhs_vec = aligned16(rhs) && K % 8 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (big_tiles(n_tasks, rows_per_task, n_sm[dev]))
    err = launch_as<Lhs, BIG_WARPS, BIG_STAGES>(
        lhs, rhs, hap, pc, best, n_tasks, rows_per_task, S, K, n_blocks,
        rh_units, lhs_vec, rhs_vec, dev, st);
  else
    err = launch_as<Lhs, SMALL_WARPS, SMALL_STAGES>(
        lhs, rhs, hap, pc, best, n_tasks, rows_per_task, S, K, n_blocks,
        rh_units, lhs_vec, rhs_vec, dev, st);
  return (int)err;
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError() as an int.
// alleles int8 and weights bf16, both (n_tasks * rows_per_task, S).
int duet_haplotag_score(const void* alleles, const void* weights,
                        const void* rhs, void* hap, void* pc, void* best,
                        int n_tasks, int rows_per_task, int S, int K,
                        int n_blocks, void* stream) {
  const FusedAw lhs{(const int8_t*)alleles, (const __nv_bfloat16*)weights};
  return launch(lhs, aligned16(alleles) && aligned16(weights), rhs, hap, pc,
                best, n_tasks, rows_per_task, S, K, n_blocks, stream);
}

// The _kernel variant: aw and abs_aw bf16, both (n_tasks * rows_per_task, S).
int duet_haplotag_score_pre(const void* aw, const void* abs_aw,
                            const void* rhs, void* hap, void* pc, void* best,
                            int n_tasks, int rows_per_task, int S, int K,
                            int n_blocks, void* stream) {
  const GivenAw lhs{(const __nv_bfloat16*)aw, (const __nv_bfloat16*)abs_aw};
  return launch(lhs, aligned16(aw) && aligned16(abs_aw), rhs, hap, pc, best,
                n_tasks, rows_per_task, S, K, n_blocks, stream);
}

// The launch shape the score kernel takes for these sizes on the current
// device: warps per CTA, ring stages and dynamic shared memory in bytes.
int duet_haplotag_score_shape(int n_tasks, int rows_per_task, int K,
                              int fused, int* warps, int* stages,
                              int* smem) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const bool big = big_tiles(n_tasks, rows_per_task, n_sm);
  *warps = big ? BIG_WARPS : SMALL_WARPS;
  *stages = big ? BIG_STAGES : SMALL_STAGES;
  const int lhs = fused ? FusedAw::stage_bytes(*warps * 16)
                        : GivenAw::stage_bytes(*warps * 16);
  *smem = *stages * (lhs + SK * rh_units_for(K) * 16);
  return 0;
}

const char* duet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
