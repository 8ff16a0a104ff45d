// One phasing power-iteration sweep for Hopper (sm_90a): the CUDA
// counterpart of the Pallas kernel
// duet_tpu/ops/pallas_haplotag.py::_sweep_kernel (:71), which
// phase_and_tag_fused launches once per sweep (:155).
//
// What it computes.  Over a dense (R x S) window of int8 alleles and bf16
// quality weights, with the current (S,) bf16 site phase:
//   aw       = bf16(allele * weight)          (built on chip, never stored)
//   h[r]     = sign(sum_s aw[r, s] * phase[s])
//   votes[s] = sum_r h[r] * aw[r, s]
// The caller turns the votes into the next phase.  Alleles are -1/0/+1 and
// weights are quality weights, integers <= 40, so every product is an
// integer of magnitude <= 40: the row sums are exact in fp32 while
// 40 * S < 2^24 and the votes are summed as int32, which is exact, and the
// same, in any order.  The plain torch version
// (ops.haplotag.power_sweep_votes) is exact while 40 * R < 2^24 as well,
// which is where the two are pinned bit-equal.
//
// What bounds it.  One sweep must read the window once: R * S * 3 bytes
// (403 MB at the bench shape R = 32768, S = 4096: 0.120 ms at 3.35 TB/s).
// The arithmetic, two multiply-adds an element, is far below the card's
// rate.  It is bound by bytes, and the design is about reading each byte
// of the window from HBM once, with enough of them in flight.
//
// The one-pass arm (S up to the one-CTA row limit below; the bench and
// quick shapes take it).
//   - A persistent grid: min(tiles, CTAs per SM x SMs) CTAs of 512 threads
//     walk tiles of `rows` whole rows (8, halved while a ring of them does
//     not fit the 227 KB a block may use).  A tile's rows are contiguous in
//     memory, so it is copied as one flat run of 16-byte cp.async.cg copies
//     into a ring of 2 stages: the next tile's copies are in flight while
//     this one is worked on.  Inputs that are not 16-byte aligned
//     (S % 16 != 0) are staged element by element into the same layout:
//     right at any shape, and slower.
//   - The tile stays resident from the row sums to the votes: each byte of
//     the window is read from HBM exactly once per sweep.
//   - No dependent loads: a zero allele is skipped in arithmetic only.  A
//     thread owns 8-site chunks; it reads 8 alleles (8 bytes) and 8 weights
//     (16 bytes) of a row from shared memory, forms aw two sites at a time
//     as bf16x2 with __hmul2 (rounded like the reference's bf16 multiply;
//     the int8 -> bf16 step is a byte permute and an fp32 subtract, exact
//     for every int8), writes aw back over the weights, and adds aw * phase
//     to the row's fp32 sum.  Row sums meet through warp shuffles and
//     shared memory; h is kept in shared memory.  Votes: the same thread
//     sums h * aw over the tile's rows (rows with h = 0 are skipped) and
//     adds it to its sites' int32 partials in shared memory.
//   - One atomicAdd per site per CTA, after the CTA's last tile: at most
//     (CTAs) x S atomics a sweep (132 x 4096 at the bench shape on an
//     H100), instead of one per site per 64 rows.
//   - The phase (S bf16) is staged once per CTA.
//   - CUDA cores, not tensor cores: an mma needs 16 rows (k = 16) of the
//     votes product resident, 192 KB a stage at S = 4096, which leaves no
//     room for a second stage; and the arithmetic is not what bounds it.
// Shared memory: 2 x rows x S_pad x 3 (the ring) + S_pad x 6 (phase,
// vote partials) + 544 bytes, S_pad = S rounded up to 16.  With 8 rows the
// ring holds S up to 4288; 1 row holds S up to 19,312 (the one-CTA row
// limit on an H100's 232,448 bytes).
//
// The rereading arm (S above the one-CTA row limit: 19,313 and up on an
// H100).  A whole row no longer fits a ring of two in shared memory.  A CTA
// of 8 warps takes 8 rows: pass 1, a warp per row, sums the row from HBM;
// pass 2 reads the CTA's 8 rows again (now mostly from L2) for the votes,
// with one atomicAdd per site per CTA.  It moves up to twice the window's
// bytes; no caller of the port has rows this long.
//
// sweep_shape() decides the arm, rows, CTAs and shared memory for both the
// launch and the report (duet_haplotag_sweep_shape), so the two cannot
// disagree.  Build variants change the one-pass arm's shape: -DSW_THREADS,
// -DSW_ROWS, -DSW_STAGES and -DSW_CTAS_PER_SM (the cap on resident CTAs);
// duet_tpu_torch/sweep_variants.py times them on the card (PERF.md).
//
// Built by nvcc into a shared library with a plain C interface
// (duet_tpu_torch/ops/cuda_build.py); the launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SW_THREADS
#define SW_THREADS 512
#endif
#ifndef SW_ROWS
#define SW_ROWS 8
#endif
#ifndef SW_STAGES
#define SW_STAGES 2
#endif
#ifndef SW_CTAS_PER_SM
#define SW_CTAS_PER_SM 2
#endif

namespace {

constexpr int THREADS = SW_THREADS;          // one-pass arm: threads a CTA
constexpr int ROWS = SW_ROWS;                // the most rows a tile
constexpr int STAGES = SW_STAGES;            // ring stages
constexpr int CTAS_PER_SM = SW_CTAS_PER_SM;  // cap on resident CTAs
constexpr int LONG_WARPS = 8;                // rereading arm: rows a CTA
constexpr int LONG_THREADS = 32 * LONG_WARPS;
constexpr int ARM_ONE_PASS = 0, ARM_REREAD = 1;
constexpr int COPY_ELEMENT = 0, COPY_CP_ASYNC = 1;

static_assert(STAGES >= 2, "the ring needs two stages");
static_assert(ROWS >= 1 && (ROWS & (ROWS - 1)) == 0, "ROWS: a power of 2");

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

// bf16 pair (a0 * w0, a1 * w1) of bytes `lo`, `lo + 1` of four int8
// alleles (x = the alleles ^ 0x80808080, so a byte holds a + 128) and a
// bf16 weight pair.  2^23 + (a + 128) built by a byte permute, less
// 2^23 + 128, is a in fp32, exact; the bf16 product rounds like the
// reference's bf16 multiply.
template <int LO>
__device__ __forceinline__ uint32_t aw_pair(uint32_t x, uint32_t w2) {
  const float a0 =
      __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 + LO)) - 8388736.0f;
  const float a1 =
      __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7441 + LO)) - 8388736.0f;
  const __nv_bfloat162 a = __floats2bfloat162_rn(a0, a1);
  const __nv_bfloat162 p =
      __hmul2(a, *reinterpret_cast<const __nv_bfloat162*>(&w2));
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// Shared-memory layout of the one-pass arm, in bytes
struct Layout {
  int s_pad, stage, phase, partial, red, hs, total;
};

__host__ __device__ inline Layout layout(int S, int rows) {
  Layout l;
  l.s_pad = (S + 15) / 16 * 16;
  l.stage = rows * l.s_pad * 3;              // alleles, then weights / aw
  l.phase = STAGES * l.stage;                // the ring first
  l.partial = l.phase + l.s_pad * 2;         // int32 vote partials
  l.red = l.partial + l.s_pad * 4;           // (warps, ROWS) fp32 sums
  l.hs = l.red + (THREADS / 32) * ROWS * 4;  // ROWS fp32 signs
  l.total = l.hs + ROWS * 4;
  return l;
}

template <int NT, int NR, int NS>
__global__ void __launch_bounds__(NT)
haplotag_sweep_one_pass(const int8_t* __restrict__ alleles,
                        const __nv_bfloat16* __restrict__ weights,
                        const __nv_bfloat16* __restrict__ phase,
                        int32_t* __restrict__ votes, int R, int S, int rows,
                        bool vec) {
  static_assert(NT == THREADS && NR == ROWS && NS == STAGES, "one shape");
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = layout(S, rows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_chunks = L.s_pad / 8;          // 8-site chunks a row
  const int n_tiles = (R + rows - 1) / rows;
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  uint4* ph_s = reinterpret_cast<uint4*>(smem + L.phase);
  int4* part_s = reinterpret_cast<int4*>(smem + L.partial);
  float* red_s = reinterpret_cast<float*>(smem + L.red);
  float* h_s = reinterpret_cast<float*>(smem + L.hs);
  auto first_row = [&](int i) {
    return (int64_t)(blockIdx.x + (int64_t)i * gridDim.x) * rows;
  };

  // tile i of this CTA into stage i % NS: its rows are one flat run of
  // n_rows * S alleles and of weights
  auto issue = [&](int i) {
    if (i < my_tiles) {
      const int64_t row0 = first_row(i);
      const int n_rows = (int)min((int64_t)rows, (int64_t)R - row0);
      uint8_t* al = smem + (i % NS) * L.stage;
      uint8_t* wt = al + rows * L.s_pad;
      if (vec) {
        const int8_t* ga = alleles + row0 * S;
        const __nv_bfloat16* gw = weights + row0 * S;
        for (int v = threadIdx.x; v < n_rows * S / 16; v += NT)
          cp_async16(al + 16 * v, ga + 16 * v, 16);
        for (int v = threadIdx.x; v < n_rows * S / 8; v += NT)
          cp_async16(wt + 16 * v, gw + 8 * v, 16);
      } else {
        __nv_bfloat16* wt16 = reinterpret_cast<__nv_bfloat16*>(wt);
        for (int idx = threadIdx.x; idx < n_rows * L.s_pad; idx += NT) {
          const int r = idx / L.s_pad, s = idx - r * L.s_pad;
          const bool ok = s < S;
          const int64_t off = (row0 + r) * S + s;
          al[idx] = ok ? (uint8_t)alleles[off] : 0;
          wt16[idx] = ok ? weights[off] : __float2bfloat16(0.0f);
        }
      }
    }
    cp_async_commit();                       // one group a tile, maybe empty
  };
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) issue(st);

  // the phase, zero past S, and the vote partials, once per CTA
  __nv_bfloat16* ph16 = reinterpret_cast<__nv_bfloat16*>(ph_s);
  for (int s = threadIdx.x; s < L.s_pad; s += NT)
    ph16[s] = s < S ? phase[s] : __float2bfloat16(0.0f);
  for (int c = threadIdx.x; c < 2 * n_chunks; c += NT)
    part_s[c] = make_int4(0, 0, 0, 0);

  for (int i = 0; i < my_tiles; ++i) {
    cp_async_wait<NS - 2>();                 // this thread's copies landed
    __syncthreads();                         // everyone's; tile i-1 is done
    issue(i + NS - 1);
    const int live = (int)min((int64_t)rows, (int64_t)R - first_row(i));
    uint8_t* al = smem + (i % NS) * L.stage;
    uint4* wt = reinterpret_cast<uint4*>(al + rows * L.s_pad);

    // row sums: aw built once, written back over the weights
    float acc[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[r] = 0.0f;
    for (int c = threadIdx.x; c < n_chunks; c += NT) {
      const uint4 p4 = ph_s[c];
      const float p[8] = {lo_f(p4.x), hi_f(p4.x), lo_f(p4.y), hi_f(p4.y),
                          lo_f(p4.z), hi_f(p4.z), lo_f(p4.w), hi_f(p4.w)};
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r < live) {
          const uint2 a8 =
              *reinterpret_cast<const uint2*>(al + r * L.s_pad + 8 * c);
          const uint4 w8 = wt[r * n_chunks + c];
          const uint32_t x0 = a8.x ^ 0x80808080u, x1 = a8.y ^ 0x80808080u;
          uint4 aw;
          aw.x = aw_pair<0>(x0, w8.x);
          aw.y = aw_pair<2>(x0, w8.y);
          aw.z = aw_pair<0>(x1, w8.z);
          aw.w = aw_pair<2>(x1, w8.w);
          wt[r * n_chunks + c] = aw;
          float a = acc[r];
          a = fmaf(lo_f(aw.x), p[0], a);
          a = fmaf(hi_f(aw.x), p[1], a);
          a = fmaf(lo_f(aw.y), p[2], a);
          a = fmaf(hi_f(aw.y), p[3], a);
          a = fmaf(lo_f(aw.z), p[4], a);
          a = fmaf(hi_f(aw.z), p[5], a);
          a = fmaf(lo_f(aw.w), p[6], a);
          a = fmaf(hi_f(aw.w), p[7], a);
          acc[r] = a;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float a = acc[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) red_s[warp * NR + r] = a;
    }
    __syncthreads();
    if (threadIdx.x < NR) {
      float t = 0.0f;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) t += red_s[w * NR + threadIdx.x];
      h_s[threadIdx.x] =
          (int)threadIdx.x < live ? (float)((t > 0.0f) - (t < 0.0f)) : 0.0f;
    }
    __syncthreads();

    // votes: sum over the tile's rows of h * aw, into the int32 partials
    float h[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) h[r] = h_s[r];
    for (int c = threadIdx.x; c < n_chunks; c += NT) {
      float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (h[r] != 0.0f) {                  // uniform across the CTA
          const uint4 aw = wt[r * n_chunks + c];
          v[0] = fmaf(h[r], lo_f(aw.x), v[0]);
          v[1] = fmaf(h[r], hi_f(aw.x), v[1]);
          v[2] = fmaf(h[r], lo_f(aw.y), v[2]);
          v[3] = fmaf(h[r], hi_f(aw.y), v[3]);
          v[4] = fmaf(h[r], lo_f(aw.z), v[4]);
          v[5] = fmaf(h[r], hi_f(aw.z), v[5]);
          v[6] = fmaf(h[r], lo_f(aw.w), v[6]);
          v[7] = fmaf(h[r], hi_f(aw.w), v[7]);
        }
      }
      int4 q0 = part_s[2 * c], q1 = part_s[2 * c + 1];
      q0.x += __float2int_rn(v[0]);
      q0.y += __float2int_rn(v[1]);
      q0.z += __float2int_rn(v[2]);
      q0.w += __float2int_rn(v[3]);
      q1.x += __float2int_rn(v[4]);
      q1.y += __float2int_rn(v[5]);
      q1.z += __float2int_rn(v[6]);
      q1.w += __float2int_rn(v[7]);
      part_s[2 * c] = q0;
      part_s[2 * c + 1] = q1;
    }
  }
  cp_async_wait<0>();

  // one atomicAdd per site the CTA voted on (each thread its own chunks)
  const int32_t* part = reinterpret_cast<const int32_t*>(part_s);
  for (int c = threadIdx.x; c < n_chunks; c += NT)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int s = 8 * c + k;
      if (s < S && part[s] != 0) atomicAdd(&votes[s], part[s]);
    }
}

// The rereading arm, for rows too long for a ring of two in shared memory:
// 8 rows a CTA, a warp per row for the sums, then a thread per site over
// the CTA's rows again (from L2) for the votes.
__global__ void __launch_bounds__(LONG_THREADS)
haplotag_sweep_reread(const int8_t* __restrict__ alleles,
                      const __nv_bfloat16* __restrict__ weights,
                      const __nv_bfloat16* __restrict__ phase,
                      int32_t* __restrict__ votes, int R, int S) {
  __shared__ float h_s[LONG_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row0 = (int64_t)blockIdx.x * LONG_WARPS;
  const int n_rows = (int)min((int64_t)LONG_WARPS, (int64_t)R - row0);
  float acc = 0.0f;
  if (warp < n_rows) {
    const int64_t base = (row0 + warp) * S;
    for (int s = lane; s < S; s += 32) {
      const float aw = __bfloat162float(__float2bfloat16(
          (float)alleles[base + s] * __bfloat162float(weights[base + s])));
      acc = fmaf(aw, __bfloat162float(phase[s]), acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) h_s[warp] = (float)((acc > 0.0f) - (acc < 0.0f));
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += LONG_THREADS) {
    int v = 0;
    for (int r = 0; r < n_rows; ++r) {
      const int64_t off = (row0 + r) * S + s;
      const float aw = __bfloat162float(__float2bfloat16(
          (float)alleles[off] * __bfloat162float(weights[off])));
      v += (int)(h_s[r] * aw);
    }
    if (v != 0) atomicAdd(&votes[s], v);
  }
}

using OnePass = void (*)(const int8_t*, const __nv_bfloat16*,
                         const __nv_bfloat16*, int32_t*, int, int, int, bool);
const OnePass one_pass_kernel =
    haplotag_sweep_one_pass<THREADS, ROWS, STAGES>;

struct Shape {
  int arm, rows, stages, ctas, ctas_per_sm, cluster, smem, copy;
};

struct Device {
  int n_sm = 0, max_smem = 0, ready = 0;
  int occ_smem = -1, occ = 0;                // the last occupancy query
};

// Per-device facts, read once; the one-pass kernel's dynamic shared memory
// cap raised to the device's opt-in maximum
cudaError_t device_facts(Device** out) {
  static Device devs[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  Device& d = devs[dev];
  if (!d.ready) {
    err = cudaDeviceGetAttribute(&d.n_sm, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &d.max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(one_pass_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 d.max_smem);
    if (err != cudaSuccess) return err;
    d.ready = 1;
  }
  *out = &d;
  return cudaSuccess;
}

// The launch shape for (R, S), inputs 16-byte aligned or not (`aligned`):
// the most rows (ROWS, halved) whose ring fits the block's shared memory;
// if one row does not fit, the rereading arm.  The launch and
// duet_haplotag_sweep_shape both take it from here.
cudaError_t sweep_shape(int R, int S, bool aligned, Shape* sh) {
  Device* d = nullptr;
  cudaError_t err = device_facts(&d);
  if (err != cudaSuccess) return err;
  int rows = ROWS;
  while (rows > 1 && layout(S, rows).total > d->max_smem) rows /= 2;
  const Layout L = layout(S, rows);
  sh->cluster = 1;
  if (L.total > d->max_smem) {
    sh->arm = ARM_REREAD;
    sh->rows = LONG_WARPS;
    sh->stages = 0;
    sh->ctas = (R + LONG_WARPS - 1) / LONG_WARPS;
    sh->ctas_per_sm = 0;
    sh->smem = 0;
    sh->copy = COPY_ELEMENT;
    return cudaSuccess;
  }
  if (d->occ_smem != L.total) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &d->occ, one_pass_kernel, THREADS, L.total);
    if (err != cudaSuccess) return err;
    d->occ_smem = L.total;
  }
  const int per_sm = d->occ < 1             ? 1
                     : d->occ > CTAS_PER_SM ? CTAS_PER_SM
                                            : d->occ;
  const int n_tiles = (R + rows - 1) / rows;
  sh->arm = ARM_ONE_PASS;
  sh->rows = rows;
  sh->stages = STAGES;
  sh->ctas_per_sm = per_sm;
  sh->ctas = n_tiles < per_sm * d->n_sm ? n_tiles : per_sm * d->n_sm;
  sh->smem = L.total;
  sh->copy = aligned && S % 16 == 0 ? COPY_CP_ASYNC : COPY_ELEMENT;
  return cudaSuccess;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

// Zero `votes` (S int32) and launch on `stream` (a cudaStream_t); returns
// the first CUDA error as an int (0 on success).
int duet_haplotag_sweep(const void* alleles, const void* weights,
                        const void* phase, void* votes, int R, int S,
                        void* stream) {
  if (R < 1 || S < 1) return (int)cudaErrorInvalidValue;
  Shape sh;
  cudaError_t err =
      sweep_shape(R, S, aligned16(alleles) && aligned16(weights), &sh);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  err = cudaMemsetAsync(votes, 0, (size_t)S * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  if (sh.arm == ARM_ONE_PASS)
    one_pass_kernel<<<sh.ctas, THREADS, sh.smem, st>>>(
        (const int8_t*)alleles, (const __nv_bfloat16*)weights,
        (const __nv_bfloat16*)phase, (int32_t*)votes, R, S, sh.rows,
        sh.copy != COPY_ELEMENT);
  else
    haplotag_sweep_reread<<<sh.ctas, LONG_THREADS, 0, st>>>(
        (const int8_t*)alleles, (const __nv_bfloat16*)weights,
        (const __nv_bfloat16*)phase, (int32_t*)votes, R, S);
  return (int)cudaGetLastError();
}

// The launch shape of an (R, S) sweep on 16-byte aligned inputs on the
// current device, into out[8]: arm (0 one-pass, 1 rereading), rows a tile,
// ring stages, CTAs in the grid and resident on an SM, cluster size,
// dynamic shared memory in bytes, and how a tile is staged (0 element by
// element, 1 16-byte cp.async).
int duet_haplotag_sweep_shape(int R, int S, int* out) {
  if (R < 1 || S < 1) return (int)cudaErrorInvalidValue;
  Shape sh;
  const cudaError_t err = sweep_shape(R, S, true, &sh);
  if (err != cudaSuccess) return (int)err;
  const int v[8] = {sh.arm, sh.rows, sh.stages, sh.ctas, sh.ctas_per_sm,
                    sh.cluster, sh.smem, sh.copy};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

const char* duet_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
