// One phasing power-iteration sweep for Hopper (sm_90a): the CUDA
// counterpart of the Pallas kernel
// duet_tpu/ops/pallas_haplotag.py::_sweep_kernel, which
// phase_and_tag_fused runs once per sweep.
//
// What it computes.  Over a dense (R x S) window of int8 alleles and bf16
// quality weights, with the current (S,) bf16 site phase:
//   aw       = bf16(allele * weight)          (built on chip, never stored)
//   h[r]     = sign(sum_s aw[r, s] * phase[s])
//   votes[s] = sum_r h[r] * aw[r, s]
// The caller turns the votes into the next phase.  Weights are quality
// weights, integers <= 40, so every product is an integer of magnitude
// <= 40: the row sums are exact in fp32 while 40 * S < 2^24 and the votes
// are summed as int32, which is exact, and the same, in any order.  The
// plain torch version (ops.haplotag.power_sweep_votes) is exact while
// 40 * R < 2^24 as well, which is where the two are pinned bit-equal.
//
// What differs from the TPU kernel.  There the votes accumulate across a
// sequential grid of 256-row tiles in one VMEM buffer.  Here CTAs run
// concurrently, so the (S,) votes are a reduction across CTAs: each CTA owns
// SW_ROWS whole rows, sums its share per site in registers, and adds it to
// the global votes with one int32 atomicAdd per site it touches.
//
// What bounds it.  One sweep must read the window once (R * S * 3 bytes:
// ~403 MB at the bench shape R = 32768, S = 4096, ~0.12 ms at 3.35 TB/s);
// the arithmetic is one multiply-add per element per pass.  It is
// memory-bound.
//
// What the design does about it.  Pass 1: one warp per row, lanes over
// consecutive sites (coalesced), a warp-shuffle sum, h kept in shared
// memory.  Pass 2: one thread per site, looping over the CTA's rows
// (coalesced across threads), skipping rows with h = 0 and zero alleles.
// Pass 2 reads the rows pass 1 just read, mostly from L2; a single pass that
// keeps the tile in shared memory, and vector loads, are later work.
//
// Built by nvcc into a shared library with a plain C interface
// (duet_tpu_torch/ops/cuda_build.py); the launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SW_ROWS = 64;                  // read rows per CTA
constexpr int SW_THREADS = 256;
constexpr int SW_WARPS = SW_THREADS / 32;

__device__ __forceinline__ float bf16_aw(int a, __nv_bfloat16 w) {
  // bf16 product, rounded like the reference's bf16 multiply
  return __bfloat162float(__float2bfloat16((float)a * __bfloat162float(w)));
}

__global__ void __launch_bounds__(SW_THREADS)
haplotag_sweep_kernel(const int8_t* __restrict__ alleles,
                      const __nv_bfloat16* __restrict__ weights,
                      const __nv_bfloat16* __restrict__ phase,
                      int32_t* __restrict__ votes, int R, int S) {
  __shared__ float h_s[SW_ROWS];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * SW_ROWS;
  const int n_rows = min(SW_ROWS, R - row0);

  // pass 1: h = sign(aw @ phase) for the CTA's rows; the whole row is
  // summed before any vote is added
  for (int r = warp; r < SW_ROWS; r += SW_WARPS) {
    float acc = 0.0f;
    if (r < n_rows) {
      const int64_t base = (int64_t)(row0 + r) * S;
      for (int s = lane; s < S; s += 32) {
        const int a = alleles[base + s];
        if (a != 0)
          acc = fmaf(bf16_aw(a, weights[base + s]),
                     __bfloat162float(phase[s]), acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) h_s[r] = (float)((acc > 0.0f) - (acc < 0.0f));
  }
  __syncthreads();

  // pass 2: votes[s] += sum over the CTA's rows of h * aw
  for (int s = threadIdx.x; s < S; s += SW_THREADS) {
    int v = 0;
    for (int r = 0; r < n_rows; ++r) {
      const float h = h_s[r];
      if (h == 0.0f) continue;
      const int64_t off = (int64_t)(row0 + r) * S + s;
      const int a = alleles[off];
      if (a != 0) v += (int)(h * bf16_aw(a, weights[off]));
    }
    if (v != 0) atomicAdd(&votes[s], v);
  }
}

}  // namespace

extern "C" {

// Zero `votes` (S int32) and launch on `stream` (a cudaStream_t); returns
// the first CUDA error as an int (0 on success).
int duet_haplotag_sweep(const void* alleles, const void* weights,
                        const void* phase, void* votes, int R, int S,
                        void* stream) {
  if (R < 1 || S < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(votes, 0, (size_t)S * sizeof(int32_t),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int grid = (R + SW_ROWS - 1) / SW_ROWS;
  haplotag_sweep_kernel<<<grid, SW_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)alleles, (const __nv_bfloat16*)weights,
      (const __nv_bfloat16*)phase, (int32_t*)votes, R, S);
  return (int)cudaGetLastError();
}

const char* duet_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
