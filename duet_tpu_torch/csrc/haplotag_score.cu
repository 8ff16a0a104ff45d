// Haplotag read scoring for Hopper (sm_90a): the CUDA counterpart of the
// Pallas kernels duet_tpu/ops/pallas_haplotag.py::_score_kernel (launched by
// haplotag_score_batch_pallas with one rhs per task, and by
// phase_and_tag_fused with one rhs shared by every row tile) and ::_kernel
// (the same math on an aw and |aw| computed outside the kernel, launched by
// haplotag_score_pallas).
//
// What it computes.  n_tasks independent scoring tasks, each a stack of
// rows_per_task reads over S het sites with its own (S, K) right-hand side
// rhs = [phase | informative | block one-hot ...].  Per read row:
//   aw      = bf16(allele * weight)   (built on chip, never stored), or the
//             given bf16 aw with its given |aw| (the _kernel variant)
//   signed  = sum_s aw[s]  * rhs[s, 0]
//   total   = sum_s |aw[s]| * rhs[s, 1]
//   blockw  = sum_s |aw[s]| * rhs[s, 2 + b]          for b < n_blocks
//   hap     = total > 0 && signed != 0 ? (signed > 0 ? 1 : 2) : 0
//   pc      = hap ? clip(rint(10 * |signed|), 1, 8100) : -1
//   best    = the FIRST b with the largest blockw (lowest index on ties)
// A task of rows_per_task = R with n_tasks = 1 is the shared-rhs launch.
// Outputs are three int32 vectors; the TPU kernel's 128-lane packed tile
// was a TPU layout choice and is not carried over.  Every product is an
// integer (|aw| <= 40 for quality weights, rhs in {-1, 0, 1}) and every
// partial sum stays below 2^24, so fp32 accumulation is exact in any order:
// the results are bit-identical to the plain torch versions.
//
// What bounds it.  At the pipeline's launch shape (16 tasks x 256 rows,
// S = 2304, K = 128) one launch reads ~28 MB of int8 + bf16 matrix and
// ~9.4 MB of rhs, and the dense product is ~2.4 GFLOP of fp32 FMA work
// (one product per output column).  That is ~64 FLOP/byte: on CUDA cores
// (67 TFLOP/s fp32 against 3.35 TB/s on an H100 SXM) the dense kernel is
// compute-bound, far off the memory roof.
//
// What the design does about it.  Each CTA owns one (task, 32-row tile)
// and streams the task's rhs through shared memory in 32-site chunks; the
// 32 x 128 outputs of one column slab live in fp32 registers (2 rows x 8
// columns a thread).  A rhs wider than 128 columns is walked in 128-column
// slabs, re-reading the tile's rows for each slab and carrying the running
// first maximum (value, lowest block) across slabs.  The pipeline's allele
// windows are very sparse and the rows of a tile are reads sorted by
// position, so a tile's reads cover a narrow band of sites: a chunk whose
// 32 x 32 allele block is all zero is skipped before its rhs is loaded (one
// __syncthreads_or), which removes most of the FMA work and rhs traffic
// there.  Tensor-core products (mma / wgmma) and TMA staging are left for
// later work.
//
// Built by nvcc into a shared library with a plain C interface
// (duet_tpu_torch/ops/cuda_build.py); each launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE_M = 32;                   // read rows per CTA
constexpr int SC = 32;                       // sites per shared-memory chunk
constexpr int SLAB = 128;                    // rhs columns held at a time
constexpr int TX = 16;                       // threads across columns
constexpr int TY = 16;                       // threads across rows
constexpr int THREADS = TX * TY;
constexpr int ROWS_PT = TILE_M / TY;         // rows per thread
constexpr int COLS_PT = SLAB / TX;           // columns per thread
constexpr float PC_PER_MARGIN = 10.0f;
constexpr float PC_MAX = 8100.0f;

static_assert(TILE_M % TY == 0 && SLAB % TX == 0, "tile shape");
static_assert((TILE_M * SC) % THREADS == 0, "allele staging");
static_assert((SC * SLAB) % THREADS == 0, "rhs staging");
static_assert(TX <= 32 && 32 % TX == 0, "a row group must sit in one warp");

// aw = bf16(allele * weight), formed on chip (_score_kernel)
struct FusedAw {
  const int8_t* alleles;
  const __nv_bfloat16* weights;

  __device__ void load(int64_t off, float& v, float& av) const {
    const int a = alleles[off];
    v = 0.0f;
    if (a != 0) {
      // bf16 product, rounded like the reference's bf16 multiply
      v = __bfloat162float(
          __float2bfloat16((float)a * __bfloat162float(weights[off])));
    }
    av = fabsf(v);
  }
};

// aw and |aw| given as bf16 matrices (_kernel)
struct GivenAw {
  const __nv_bfloat16* aw;
  const __nv_bfloat16* abs_aw;

  __device__ void load(int64_t off, float& v, float& av) const {
    v = __bfloat162float(aw[off]);
    av = __bfloat162float(abs_aw[off]);
  }
};

template <class Lhs>
__global__ void __launch_bounds__(THREADS)
haplotag_score_kernel(Lhs lhs, const __nv_bfloat16* __restrict__ rhs,
                      int32_t* __restrict__ hap, int32_t* __restrict__ pc,
                      int32_t* __restrict__ best, int rows_per_task, int S,
                      int K, int n_blocks) {
  // a_s / ab_s hold aw / |aw| site-major with one pad column so that the
  // staging writes (consecutive threads -> consecutive sites) hit distinct
  // banks
  __shared__ float a_s[SC][TILE_M + 1];
  __shared__ float ab_s[SC][TILE_M + 1];
  __shared__ float b_s[SC][SLAB];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int lane = tid & 31;
  const int group_lane0 = lane & ~(TX - 1);
  const int row0 = blockIdx.x * TILE_M;                 // within the task
  const int64_t task_row0 = (int64_t)blockIdx.y * rows_per_task;
  const __nv_bfloat16* rhs_t = rhs + (int64_t)blockIdx.y * S * K;

  float sgn[ROWS_PT], tot[ROWS_PT], best_v[ROWS_PT];
  int best_b[ROWS_PT];
#pragma unroll
  for (int i = 0; i < ROWS_PT; ++i) {
    sgn[i] = tot[i] = 0.0f;
    best_v[i] = -INFINITY;
    best_b[i] = 0x7fffffff;
  }

  for (int c0 = 0; c0 < K; c0 += SLAB) {
    // column 0 of the first slab (signed) takes aw itself, every other
    // column |aw|
    const bool signed_col = (c0 == 0 && tx == 0);
    float acc[ROWS_PT][COLS_PT];
#pragma unroll
    for (int i = 0; i < ROWS_PT; ++i)
#pragma unroll
      for (int j = 0; j < COLS_PT; ++j) acc[i][j] = 0.0f;

    for (int s0 = 0; s0 < S; s0 += SC) {
      int nz = 0;
#pragma unroll
      for (int e = 0; e < (TILE_M * SC) / THREADS; ++e) {
        const int idx = tid + e * THREADS;
        const int r = idx / SC;
        const int s = idx % SC;
        const int row = row0 + r;
        const int col = s0 + s;
        float v = 0.0f, av = 0.0f;
        if (row < rows_per_task && col < S)
          lhs.load((task_row0 + row) * S + col, v, av);
        nz |= (v != 0.0f) | (av != 0.0f);
        a_s[s][r] = v;
        ab_s[s][r] = av;
      }
      // uniform across the CTA: skip a chunk with no allele in this tile
      if (!__syncthreads_or(nz)) continue;

#pragma unroll
      for (int e = 0; e < (SC * SLAB) / THREADS; ++e) {
        const int idx = tid + e * THREADS;
        const int k = idx / SLAB;
        const int c = c0 + idx % SLAB;
        const int s = s0 + k;
        b_s[k][idx % SLAB] = (s < S && c < K)
                                 ? __bfloat162float(rhs_t[(int64_t)s * K + c])
                                 : 0.0f;
      }
      __syncthreads();

#pragma unroll 4
      for (int k = 0; k < SC; ++k) {
        float b[COLS_PT];
#pragma unroll
        for (int j = 0; j < COLS_PT; ++j) b[j] = b_s[k][tx + j * TX];
#pragma unroll
        for (int i = 0; i < ROWS_PT; ++i) {
          const int r = ty * ROWS_PT + i;
          const float aa = ab_s[k][r];
          acc[i][0] = fmaf(signed_col ? a_s[k][r] : aa, b[0], acc[i][0]);
#pragma unroll
          for (int j = 1; j < COLS_PT; ++j)
            acc[i][j] = fmaf(aa, b[j], acc[i][j]);
        }
      }
      __syncthreads();
    }

    // slab epilogue: the TX threads of a row group hold the slab's 128
    // columns, strided by TX; in the first slab column 0 is signed (tx 0),
    // column 1 total (tx 1), and the blocks start at column 2
#pragma unroll
    for (int i = 0; i < ROWS_PT; ++i) {
      float bv = -INFINITY;
      int bc = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < COLS_PT; ++j) {
        const int blk = c0 + tx + j * TX - 2;
        // columns rise with j, so a strict '>' keeps the first maximum
        if (blk >= 0 && blk < n_blocks && acc[i][j] > bv) {
          bv = acc[i][j];
          bc = blk;
        }
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
        if (ov > bv || (ov == bv && oc < bc)) {
          bv = ov;
          bc = oc;
        }
      }
      // later slabs hold higher block indices: a tie keeps the earlier one
      if (bv > best_v[i]) {
        best_v[i] = bv;
        best_b[i] = bc;
      }
      if (c0 == 0) {
        sgn[i] = __shfl_sync(0xffffffffu, acc[i][0], group_lane0);
        tot[i] = __shfl_sync(0xffffffffu, acc[i][0], group_lane0 + 1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS_PT; ++i) {
    const int row = row0 + ty * ROWS_PT + i;
    if (tx == 0 && row < rows_per_task) {
      const bool tagged = (tot[i] > 0.0f) && (sgn[i] != 0.0f);
      float m = rintf(PC_PER_MARGIN * fabsf(sgn[i]));
      m = fminf(fmaxf(m, 1.0f), PC_MAX);
      const int64_t o = task_row0 + row;
      hap[o] = tagged ? (sgn[i] > 0.0f ? 1 : 2) : 0;
      pc[o] = tagged ? (int32_t)m : -1;
      best[o] = best_b[i];
    }
  }
}

template <class Lhs>
int launch(Lhs lhs, const void* rhs, void* hap, void* pc, void* best,
           int n_tasks, int rows_per_task, int S, int K, int n_blocks,
           void* stream) {
  if (n_tasks < 1 || n_tasks > 65535 || rows_per_task < 1 || S < 1 ||
      K < 3 || n_blocks < 1 || n_blocks > K - 2)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((rows_per_task + TILE_M - 1) / TILE_M, n_tasks);
  haplotag_score_kernel<Lhs><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      lhs, (const __nv_bfloat16*)rhs, (int32_t*)hap, (int32_t*)pc,
      (int32_t*)best, rows_per_task, S, K, n_blocks);
  return (int)cudaGetLastError();
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
  return launch(lhs, rhs, hap, pc, best, n_tasks, rows_per_task, S, K,
                n_blocks, stream);
}

// The _kernel variant: aw and abs_aw bf16, both (n_tasks * rows_per_task, S).
int duet_haplotag_score_pre(const void* aw, const void* abs_aw,
                            const void* rhs, void* hap, void* pc, void* best,
                            int n_tasks, int rows_per_task, int S, int K,
                            int n_blocks, void* stream) {
  const GivenAw lhs{(const __nv_bfloat16*)aw, (const __nv_bfloat16*)abs_aw};
  return launch(lhs, rhs, hap, pc, best, n_tasks, rows_per_task, S, K,
                n_blocks, stream);
}

const char* duet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
