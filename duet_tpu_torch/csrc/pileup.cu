// The device pileup for Hopper (sm_90a): the CUDA counterpart of
// duet_tpu/ops/pileup.py's _packed_impl (:124-164), which XLA fuses for the
// TPU from the lane expansion, _hist_counts (:44-65), call_sites (:167-189)
// and jnp.nonzero(size=) with its gathers.  Two kernels, each a C entry of
// a few launches on one stream:
//
//   duet_pileup_count  (expand + count): packed reads -> a (4L + 1) int32
//                      histogram of pos * 4 + base, the last bin the
//                      sentinel of every lane that does not count;
//   duet_pileup_call   (call + compact + gather): the histogram and the
//                      reference codes -> the flat int32 readback
//                      [n_sites, site_idx*M, alt_code*M, is_het*M, depth*M,
//                      alt_count*M], M = max_sites.
//
// Inputs (the packers' two uploads, models/snp_caller.py):
//   ops4        (4, K) int32: rows op ref start, op nibble start, op
//               length; row 3 the params [n_real, -, min_depth, af_num,
//               af_den, hom_num, hom_den, min_alt].  The ops' lengths cover
//               the `total` lanes (a tail op absorbs the pad lanes).
//   payload_ref (nb + L) uint8: read nibbles, two a byte (bits 0-2 the
//               base, bit 3 the host's qual-pass bit), then L reference
//               codes (4 = never call).
//
// What it keeps of the reference, exactly.  A lane belongs to the op whose
// lanes hold it (zero-length ops own none); lanes at or past n_real do not
// count; qidx >> 1 is clamped to [0, nb - 1] as JAX clamps a gather; a
// nibble counts only if its base is < 4 and its bit 3 is set; a key
// outside [0, 4L) goes to the sentinel.  Keys are formed in 32-bit
// unsigned arithmetic and read back as int32, so a wrap gives JAX's value
// and is no C++ undefined behaviour.  Integer atomics commute: the counts
// are the same whatever order the lanes land in.  The sentinel is not
// incremented lane by lane (every pad lane would hit one address): each
// CTA subtracts what it kept, and CTA 0 adds `total`, so it ends at total
// minus the kept lanes, which is what the reference's scatter puts there.
// Site calling follows call_sites: depth the sum of the four counts,
// ref_safe = min(ref, 3), alt the first maximum (strict > in column order)
// of the counts with the ref column set to -1, the allele-frequency cuts
// as int32 products (multiplied as uint32 and read back, so they wrap as
// JAX's do).  The compaction keeps position order; n_sites is the true
// count even past M, and each slot past the sites holds site_idx 0 and
// position 0's other four fields, as jnp.nonzero(fill_value=0) and the
// gathers give them.
//
// What bounds it.  Both are bound by bytes, each input read once and each
// output written once: the count by the payload's nibbles (half a byte a
// lane), the ops (12 bytes an op) and the histogram (16 bytes a position);
// the call by one read of the histogram and the reference codes (17 bytes
// a position) and its O(M) output.  At the smoke's grouped window (~200M
// lanes, L = 2^24) the count's is ~0.38 GB: ~0.11 ms at 3.35 TB/s.  As
// built it also moves one 4-byte atomic a kept lane (~0.8 GB more), and
// the atomics' rate, not the bytes, sets its time.
//
// The design.  Count: a CTA takes OPS_PER_CTA consecutive ops.  A first
// pass sums each CTA's op lengths, one CTA scans those sums, and so each
// CTA knows its first lane without a scan of all K ops.  The CTA then
// scans its own ops' lengths in shared memory and walks its lanes with
// consecutive threads on consecutive lanes (so the nibble reads coalesce),
// finding each lane's op from the thread's last one: the same op while the
// next starts later, else a binary search of the ops' starts past it.  A
// CTA takes one op a thread, so that ops of simulated long reads (~800
// lanes) still spread over enough CTAs to fill the SMs.  Each kept lane is
// one global int32 atomicAdd.
// The pad op's lanes (at or past n_real) are never walked.  Call: a CTA
// takes POS_PER_CTA positions in rounds of one position a thread (16-byte
// loads of a position's four counts); a first pass counts each CTA's
// sites, one CTA scans the counts, and a second pass ranks each site in
// its CTA (a shuffle scan in each warp, then one of the warp totals) and
// writes it.
// Both recompute the call rather than store a mask: 17 bytes a position
// against the histogram's zeroing alone at 16.
//
// Built by nvcc into a shared library with a plain C interface
// (duet_tpu_torch/ops/cuda_build.py); each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COUNT_THREADS = 256;
constexpr int OPS_PER_CTA = COUNT_THREADS;  // one op a thread
constexpr int CALL_THREADS = 256;
constexpr int CALL_ROUNDS = 8;
constexpr int POS_PER_CTA = CALL_THREADS * CALL_ROUNDS;
constexpr int SCAN_THREADS = 1024;

// The exclusive prefix of x over the CTA's threads; *total gets the sum.
// Every thread of the CTA must call it (it synchronises twice).
template <int THREADS>
__device__ uint32_t block_exclusive_scan(uint32_t x, uint32_t* total) {
  __shared__ uint32_t warp_sum[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < THREADS / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < THREADS / 32) warp_sum[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const uint32_t before = warp == 0 ? 0 : warp_sum[warp - 1];
  *total = warp_sum[THREADS / 32 - 1];
  __syncthreads();  // warp_sum is reused by the next call
  return before + incl - x;
}

// In-place exclusive scan of v[0, n) by one CTA; v[n] gets the total.
__global__ void __launch_bounds__(SCAN_THREADS)
    scan_kernel(int32_t* v, int n) {
  const int per = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  const int b = min((int)threadIdx.x * per, n), e = min(b + per, n);
  uint32_t s = 0;
  for (int i = b; i < e; ++i) s += (uint32_t)v[i];
  uint32_t total;
  uint32_t run = block_exclusive_scan<SCAN_THREADS>(s, &total);
  for (int i = b; i < e; ++i) {
    const uint32_t x = (uint32_t)v[i];
    v[i] = (int32_t)run;
    run += x;
  }
  if (threadIdx.x == 0) v[n] = (int32_t)total;
}

// ---------------------------------------------------------------- count --

// Each CTA's sum of its OPS_PER_CTA op lengths (wrapping, as the
// reference's int32 cumsum).
__global__ void __launch_bounds__(COUNT_THREADS)
    op_block_sums(const int32_t* __restrict__ len, int K,
                  int32_t* __restrict__ sums) {
  const int op = blockIdx.x * OPS_PER_CTA + (int)threadIdx.x;
  uint32_t total;
  block_exclusive_scan<COUNT_THREADS>(op < K ? (uint32_t)len[op] : 0u,
                                      &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = (int32_t)total;
}

__global__ void __launch_bounds__(COUNT_THREADS)
    count_kernel(const int32_t* __restrict__ ops4, int K,
                 const uint8_t* __restrict__ payload, int nb, int total,
                 int length, const int32_t* __restrict__ first,
                 int32_t* __restrict__ bins) {
  __shared__ int32_t s_start[OPS_PER_CTA + 1];
  __shared__ int32_t s_ref[OPS_PER_CTA];
  __shared__ int32_t s_q[OPS_PER_CTA];
  const int op0 = blockIdx.x * OPS_PER_CTA;
  const int n = min(OPS_PER_CTA, K - op0);
  const int32_t* len = ops4 + 2 * (size_t)K;

  // the CTA's ops: starts (its first lane plus the scan of their lengths),
  // ref starts and nibble starts, into shared memory
  const int i = threadIdx.x;
  uint32_t cta_lanes;
  const uint32_t start =
      (uint32_t)first[blockIdx.x] +
      block_exclusive_scan<COUNT_THREADS>(
          i < n ? (uint32_t)len[op0 + i] : 0u, &cta_lanes);
  if (i < n) {
    s_start[i] = (int32_t)start;
    s_ref[i] = ops4[op0 + i];
    s_q[i] = ops4[(size_t)K + op0 + i];
  }
  if (threadIdx.x == 0)
    s_start[n] = (int32_t)((uint32_t)first[blockIdx.x] + cta_lanes);
  __syncthreads();

  // the lanes that can count: [0, min(n_real, total)); the last CTA's last
  // op also owns any lanes past the ops' end, as the reference's clamped
  // op index gives them
  const int32_t n_real = ops4[3 * (size_t)K];
  const int limit = min(max(n_real, 0), total);
  const int lo = max(s_start[0], 0);
  const int hi = blockIdx.x == gridDim.x - 1 ? limit : min(s_start[n], limit);
  const int sentinel = 4 * length;
  uint32_t kept = 0;
  int cur = 0;
  for (int lane = lo + (int)threadIdx.x; lane < hi; lane += COUNT_THREADS) {
    int a = cur;  // the last op that starts at or before lane
    if (a + 1 < n && s_start[a + 1] <= lane) {
      int b = n - 1;
      ++a;
      while (a < b) {
        const int m = (a + b + 1) >> 1;
        if (s_start[m] <= lane) a = m; else b = m - 1;
      }
      cur = a;
    }
    const uint32_t within = (uint32_t)lane - (uint32_t)s_start[a];
    const int32_t qidx = (int32_t)((uint32_t)s_q[a] + within);
    const int32_t at = min(max(qidx >> 1, 0), nb - 1);
    const int nib = (payload[at] >> ((qidx & 1) << 2)) & 0xF;
    const int base = nib & 7;
    if (base < 4 && (nib & 8)) {
      const int32_t key =
          (int32_t)(((uint32_t)s_ref[a] + within) * 4u + (uint32_t)base);
      if (key >= 0 && key < sentinel) {
        atomicAdd(&bins[key], 1);
        ++kept;
      }
    }
  }
  uint32_t cta_kept;
  block_exclusive_scan<COUNT_THREADS>(kept, &cta_kept);
  if (threadIdx.x == 0) {
    uint32_t add = 0u - cta_kept;
    if (blockIdx.x == 0) add += (uint32_t)total;
    atomicAdd(reinterpret_cast<unsigned int*>(bins + sentinel), add);
  }
}

// ----------------------------------------------------------------- call --

struct Params {
  int32_t min_depth, af_num, af_den, hom_num, hom_den, min_alt;
};

__device__ Params load_params(const int32_t* p) {
  return {p[2], p[3], p[4], p[5], p[6], p[7]};
}

struct Call {
  int32_t depth, alt, alt_count;
  bool site, het;
};

__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

// call_sites at position p
__device__ Call call_at(const int32_t* __restrict__ bins,
                        const uint8_t* __restrict__ ref, int p,
                        const Params& q) {
  const int4 c = reinterpret_cast<const int4*>(bins)[p];
  const int32_t cnt[4] = {c.x, c.y, c.z, c.w};
  const int32_t depth = (int32_t)((uint32_t)c.x + (uint32_t)c.y +
                                  (uint32_t)c.z + (uint32_t)c.w);
  const int r = ref[p];
  const int ref_safe = min(r, 3);
  int alt = 0;
  int32_t best = ref_safe == 0 ? -1 : cnt[0];
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    const int32_t v = ref_safe == j ? -1 : cnt[j];
    if (v > best) {
      best = v;
      alt = j;
    }
  }
  const int32_t alt_count =
      alt == 0 ? c.x : alt == 1 ? c.y : alt == 2 ? c.z : c.w;
  const bool site = depth >= q.min_depth &&
                    wrap_mul(alt_count, q.af_den) >=
                        wrap_mul(depth, q.af_num) &&
                    alt_count >= q.min_alt && r < 4 && alt != ref_safe;
  const bool het =
      wrap_mul(alt_count, q.hom_den) < wrap_mul(depth, q.hom_num);
  return {depth, alt, alt_count, site, het && site};
}

// Each CTA's count of sites over its POS_PER_CTA positions.
__global__ void __launch_bounds__(CALL_THREADS)
    site_counts(const int32_t* __restrict__ bins,
                const uint8_t* __restrict__ ref, int length,
                const int32_t* __restrict__ params,
                int32_t* __restrict__ counts) {
  const Params q = load_params(params);
  const int p0 = blockIdx.x * POS_PER_CTA;
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < CALL_ROUNDS; ++k) {
    const int p = p0 + k * CALL_THREADS + (int)threadIdx.x;
    if (p < length) s += call_at(bins, ref, p, q).site;
  }
  uint32_t total;
  block_exclusive_scan<CALL_THREADS>(s, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = (int32_t)total;
}

// Each site to its slot (its CTA's first slot plus its rank in the CTA),
// while the slot is below M; then the slots past the sites.
__global__ void __launch_bounds__(CALL_THREADS)
    compact_sites(const int32_t* __restrict__ bins,
                  const uint8_t* __restrict__ ref, int length,
                  const int32_t* __restrict__ params,
                  const int32_t* __restrict__ offsets, int n_ctas, int M,
                  int32_t* __restrict__ out) {
  const Params q = load_params(params);
  const int32_t n_sites = offsets[n_ctas];
  int32_t* site_idx = out + 1;
  int32_t* alt_code = site_idx + M;
  int32_t* is_het = alt_code + M;
  int32_t* depth = is_het + M;
  int32_t* alt_count = depth + M;
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = n_sites;
  uint32_t run = (uint32_t)offsets[blockIdx.x];
  const int p0 = blockIdx.x * POS_PER_CTA;
  for (int k = 0; k < CALL_ROUNDS; ++k) {
    const int p = p0 + k * CALL_THREADS + (int)threadIdx.x;
    Call c{};
    if (p < length) c = call_at(bins, ref, p, q);
    uint32_t round_sites;
    const uint32_t slot =
        run + block_exclusive_scan<CALL_THREADS>(c.site, &round_sites);
    if (c.site && slot < (uint32_t)M) {
      site_idx[slot] = p;
      alt_code[slot] = c.alt;
      is_het[slot] = c.het;
      depth[slot] = c.depth;
      alt_count[slot] = c.alt_count;
    }
    run += round_sites;
  }
  const int filled = (uint32_t)n_sites < (uint32_t)M ? n_sites : M;
  if (filled < M) {
    const Call c0 = call_at(bins, ref, 0, q);
    for (int s = filled + blockIdx.x * CALL_THREADS + (int)threadIdx.x;
         s < M; s += gridDim.x * CALL_THREADS) {
      site_idx[s] = 0;
      alt_code[s] = c0.alt;
      is_het[s] = c0.het;
      depth[s] = c0.depth;
      alt_count[s] = c0.alt_count;
    }
  }
}

}  // namespace

extern "C" {

// Scratch each entry needs, in int32s: one per CTA and the total.
int duet_pileup_count_scratch(int K) {
  return (K + OPS_PER_CTA - 1) / OPS_PER_CTA + 1;
}

int duet_pileup_call_scratch(int length) {
  return (length + POS_PER_CTA - 1) / POS_PER_CTA + 1;
}

// Zero `bins` ((4 * length + 1) int32) and count the `total` lanes of the
// ops into it on `stream` (a cudaStream_t).  `scratch` holds
// duet_pileup_count_scratch(K) int32s.  Returns the first CUDA error as an
// int (0 on success).
int duet_pileup_count(const void* ops4, int K, const void* payload, int nb,
                      int total, int length, void* bins, void* scratch,
                      void* stream) {
  if (K < 1 || nb < 1 || total < 0 || length < 1 || length > (1 << 28))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int ctas = duet_pileup_count_scratch(K) - 1;
  cudaError_t err = cudaMemsetAsync(
      bins, 0, (size_t)(4 * length + 1) * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  const int32_t* ops = (const int32_t*)ops4;
  int32_t* first = (int32_t*)scratch;
  op_block_sums<<<ctas, COUNT_THREADS, 0, st>>>(ops + 2 * (size_t)K, K,
                                                 first);
  scan_kernel<<<1, SCAN_THREADS, 0, st>>>(first, ctas);
  count_kernel<<<ctas, COUNT_THREADS, 0, st>>>(
      ops, K, (const uint8_t*)payload, nb, total, length, first,
      (int32_t*)bins);
  return (int)cudaGetLastError();
}

// Call and compact the sites of `bins` ((4 * length + 1) int32) against
// `ref` (length uint8) with `params` (ops4's row 3) into `out`
// ((1 + 5 * max_sites) int32) on `stream`.  `scratch` holds
// duet_pileup_call_scratch(length) int32s.
int duet_pileup_call(const void* bins, const void* ref, int length,
                     const void* params, int max_sites, void* out,
                     void* scratch, void* stream) {
  if (length < 1 || length > (1 << 28) || max_sites < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int ctas = duet_pileup_call_scratch(length) - 1;
  int32_t* offsets = (int32_t*)scratch;
  site_counts<<<ctas, CALL_THREADS, 0, st>>>(
      (const int32_t*)bins, (const uint8_t*)ref, length,
      (const int32_t*)params, offsets);
  scan_kernel<<<1, SCAN_THREADS, 0, st>>>(offsets, ctas);
  compact_sites<<<ctas, CALL_THREADS, 0, st>>>(
      (const int32_t*)bins, (const uint8_t*)ref, length,
      (const int32_t*)params, offsets, ctas, max_sites, (int32_t*)out);
  return (int)cudaGetLastError();
}

const char* duet_pileup_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
