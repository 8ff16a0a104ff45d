// The neural SNP caller's candidates and feature windows for Hopper
// (sm_90a): the card's counterpart of models/nn_snp_host.py's
// candidate_sites (:134-155) and extract_features (:54-93).  It replaces
// no TPU kernel: duet_tpu builds these in numpy on the host and uploads
// the (n, 51) float32 features.  Here the (L, 4) counts go up instead
// (16 bytes a position, a quarter of the features' 204 bytes a candidate
// at the neural caller's ~15% candidate share) and the features are made
// where the network runs, a chunk of candidates at a time.  Three C
// entries, each a few launches on one stream:
//
//   duet_snp_cand_count    the gate at every position: a bit a position
//                          (a __ballot_sync word for each 32), each CTA's
//                          count, then one CTA's scan of the counts, whose
//                          total n the caller reads back to size the
//                          outputs;
//   duet_snp_cand_compact  each candidate's pos (int64), alt_code (uint8),
//                          alt_count (int32) and depth (int64) at its
//                          rank, in ascending position order;
//   duet_snp_cand_features the (rows, 51) float32 features of the
//                          candidates [s, s + rows), in extract_features'
//                          column order: the window's 9 x 4 fractions, its
//                          9 depth channels, the ref one-hot, alt_frac and
//                          noise_frac.
//
// What it keeps of the reference, exactly.  The gate is candidate_sites':
// depth (the int64 sum of the four counts) >= min_depth, depth minus the
// ref column's count >= min_alt, ref < 4, and with the ref column
// (min(ref, 3)) set to -1 the alt is the first maximum (strict > in column
// order, as np.argmax), alt_count its count, alt_count >= min_alt and
// alt != min(ref, 3).  Integer sums and differences are formed as uint64
// and read back, so they wrap as numpy's int64 do.  Each count is
// converted to float32 once (round to nearest, as numpy's astype); a
// depth is the float32 sum of the four, left to right, which for depths
// below 2^24 is the exact integer numpy's sum gives in any order.  Every
// division is IEEE float32 '/', correctly rounded: this file builds
// without -use_fast_math, whose approximate division would change the
// bytes.  max(depth, 1),
// min(depth, 100) / 100, c[alt] / cdepth and the noise (the largest
// count with the ref and alt columns set to 0) / cdepth follow
// extract_features term for term.  A window row outside [0, L) reads as
// zeros (the reference's zero padding).  The same counts may be int32 or
// int64 (the native and the numpy counting), a template each.
//
// What bounds it: bytes.  The count reads each position's row (16 bytes
// as int32, one 16-byte load, neighbouring threads on neighbouring rows,
// BATCH rows in flight a thread) and its reference code once and writes a
// bit; the compaction reads the bit words and, again, only the
// candidates' rows (the same threads on the same positions, so a warp's
// loads and its candidates' slots stay together), and writes 21 bytes a
// candidate; the features load each candidate's 9 window rows (144
// bytes, neighbouring candidates sharing rows in L1 and L2) all at once
// and write 204 bytes, staged in shared memory so that a CTA's rows go
// out as one run of coalesced 16-byte stores.  At the q10-10x cell's shape (L =
// 6 M, n ~ 0.93 M) the least traffic, each input once and each output
// once, is ~0.3 GB: ~0.09 ms at 3.35 TB/s.
//
// Built by nvcc into a shared library with a plain C interface
// (duet_tpu_torch/ops/cuda_build.py); each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using i64 = long long;

constexpr int CAND_THREADS = 256;
constexpr int CAND_ROUNDS = 32;
constexpr int POS_PER_CTA = CAND_THREADS * CAND_ROUNDS;
constexpr int WORDS_PER_CTA = POS_PER_CTA / 32;
static_assert(WORDS_PER_CTA == CAND_THREADS, "a bit word a thread");
constexpr int BATCH = 8;                    // rows in flight a thread
constexpr int SCAN_THREADS = 1024;
constexpr int FEAT_THREADS = 128;           // a candidate a thread
constexpr int HALF_WINDOW = 4;
constexpr int N_WINDOW = 2 * HALF_WINDOW + 1;
constexpr int N_FEATURES = N_WINDOW * 5 + 6;
constexpr int DEPTH_COL = 4 * N_WINDOW;             // 36
constexpr int ONEHOT_COL = DEPTH_COL + N_WINDOW;    // 45
constexpr unsigned FULL = 0xffffffffu;

// The exclusive prefix of x over the CTA's threads; *total gets the sum.
// Every thread of the CTA must call it (it synchronises twice).  The same
// scan as pileup.cu's.
template <int THREADS>
__device__ uint32_t block_exclusive_scan(uint32_t x, uint32_t* total) {
  __shared__ uint32_t warp_sum[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < THREADS / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL, w, d);
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

// Position p's four counts: one 16-byte load a row of int32, two of
// int64.
__device__ __forceinline__ void load_row(const int32_t* counts, i64 p,
                                         int32_t c[4]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(counts) + p);
  c[0] = v.x;
  c[1] = v.y;
  c[2] = v.z;
  c[3] = v.w;
}

__device__ __forceinline__ void load_row(const i64* counts, i64 p,
                                         i64 c[4]) {
  const longlong2* row = reinterpret_cast<const longlong2*>(counts) + 2 * p;
  const longlong2 a = __ldg(row), b = __ldg(row + 1);
  c[0] = a.x;
  c[1] = a.y;
  c[2] = b.x;
  c[3] = b.y;
}

__device__ __forceinline__ i64 wrap_add(i64 a, i64 b) {
  return (i64)((uint64_t)a + (uint64_t)b);
}

__device__ __forceinline__ i64 wrap_sub(i64 a, i64 b) {
  return (i64)((uint64_t)a - (uint64_t)b);
}

struct Gate {
  const uint8_t* ref;
  i64 length, min_depth, min_alt;
};

struct Cand {
  i64 depth, alt_count;
  int alt;
  bool keep;
};

// c[j] by selects, so that c stays in registers (an indexed register
// array goes to local memory)
__device__ __forceinline__ i64 pick(const i64 c[4], int j) {
  return j == 0 ? c[0] : j == 1 ? c[1] : j == 2 ? c[2] : c[3];
}

// candidate_sites at a position with counts `raw` and reference code r,
// in int64
template <class T>
__device__ __forceinline__ Cand gate_of(const T raw[4], int r,
                                        const Gate& g) {
  const i64 c[4] = {raw[0], raw[1], raw[2], raw[3]};
  const i64 depth = wrap_add(wrap_add(c[0], c[1]), wrap_add(c[2], c[3]));
  const int rs = min(r, 3);
  int alt = 0;
  i64 best = rs == 0 ? -1 : c[0];
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    const i64 v = rs == j ? -1 : c[j];
    if (v > best) {
      best = v;
      alt = j;
    }
  }
  const i64 alt_count = pick(c, alt);
  const bool keep = depth >= g.min_depth &&
                    wrap_sub(depth, pick(c, rs)) >= g.min_alt && r < 4 &&
                    alt_count >= g.min_alt && alt != rs;
  return {depth, alt_count, alt, keep};
}

// Pass 1: a candidate bit a position (a ballot word for each 32) and each
// CTA's count over its POS_PER_CTA positions; each thread keeps BATCH
// rows in flight, then gates them.
template <class T>
__global__ void __launch_bounds__(CAND_THREADS)
    cand_count(const T* __restrict__ counts, Gate g,
               uint32_t* __restrict__ bits, int32_t* __restrict__ cta_n) {
  const i64 p0 = (i64)blockIdx.x * POS_PER_CTA + threadIdx.x;
  const i64 w0 = (i64)blockIdx.x * WORDS_PER_CTA + (threadIdx.x >> 5);
  uint32_t s = 0;
  for (int k0 = 0; k0 < CAND_ROUNDS; k0 += BATCH) {
    T c[BATCH][4];
    int r[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const i64 p = p0 + (i64)(k0 + j) * CAND_THREADS;
      r[j] = 4;  // past the end: never a candidate
      c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0;
      if (p < g.length) {
        load_row(counts, p, c[j]);
        r[j] = g.ref[p];
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const uint32_t word = __ballot_sync(FULL, gate_of(c[j], r[j], g).keep);
      if ((threadIdx.x & 31) == 0) {
        bits[w0 + (k0 + j) * (CAND_THREADS / 32)] = word;
        s += __popc(word);
      }
    }
  }
  uint32_t total;
  block_exclusive_scan<CAND_THREADS>(s, &total);
  if (threadIdx.x == 0) cta_n[blockIdx.x] = (int32_t)total;
}

// Pass 2: the positions of pass 1, each thread the same ones; a position
// whose bit is set reads its row again (BATCH in flight) and writes its
// fields at its rank: its CTA's offset, the CTA's candidates in the words
// before its word (one scan of the CTA's words), the bits below it.  A
// warp's candidates of a round take consecutive slots.
template <class T>
__global__ void __launch_bounds__(CAND_THREADS)
    cand_compact(const T* __restrict__ counts, Gate g,
                 const uint32_t* __restrict__ bits,
                 const int32_t* __restrict__ offsets, i64* __restrict__ pos,
                 uint8_t* __restrict__ alt_code,
                 int32_t* __restrict__ alt_count, i64* __restrict__ depth) {
  __shared__ uint32_t words[WORDS_PER_CTA];
  __shared__ uint32_t first[WORDS_PER_CTA];  // each word's first rank
  const uint32_t word = bits[(i64)blockIdx.x * WORDS_PER_CTA + threadIdx.x];
  uint32_t unused;
  const uint32_t before =
      block_exclusive_scan<CAND_THREADS>(__popc(word), &unused);
  words[threadIdx.x] = word;
  first[threadIdx.x] = (uint32_t)offsets[blockIdx.x] + before;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t below = (1u << lane) - 1u;
  const i64 p0 = (i64)blockIdx.x * POS_PER_CTA + threadIdx.x;
  for (int k0 = 0; k0 < CAND_ROUNDS; k0 += BATCH) {
    T c[BATCH][4];
    int r[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const uint32_t wd = words[(k0 + j) * (CAND_THREADS / 32) + warp];
      r[j] = 4;
      c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0;
      if ((wd >> lane) & 1u) {
        const i64 p = p0 + (i64)(k0 + j) * CAND_THREADS;
        load_row(counts, p, c[j]);
        r[j] = g.ref[p];
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int wl = (k0 + j) * (CAND_THREADS / 32) + warp;
      const uint32_t wd = words[wl];
      if ((wd >> lane) & 1u) {
        const Cand cd = gate_of(c[j], r[j], g);
        const uint32_t slot = first[wl] + __popc(wd & below);
        pos[slot] = p0 + (i64)(k0 + j) * CAND_THREADS;
        alt_code[slot] = (uint8_t)cd.alt;
        alt_count[slot] = (int32_t)cd.alt_count;
        depth[slot] = cd.depth;
      }
    }
  }
}

// Pass 3: a candidate a thread.  Its 9 window rows and its reference
// code are loaded first, all in flight at once (a row outside [0, L) is
// read at 0 and masked to zeros); then its 51 features go into shared
// memory (a row of 51 words a thread: 51 is odd, so no two threads of a
// warp share a bank), and the CTA's rows out as one contiguous run.
template <class T>
__global__ void __launch_bounds__(FEAT_THREADS)
    cand_features(const T* __restrict__ counts, Gate g,
                  const i64* __restrict__ pos,
                  const uint8_t* __restrict__ alt_code, int rows,
                  float* __restrict__ out) {
  __shared__ __align__(16) float tile[FEAT_THREADS * N_FEATURES];
  const int r0 = blockIdx.x * FEAT_THREADS;
  const int r = r0 + (int)threadIdx.x;
  if (r < rows) {
    float* f = tile + threadIdx.x * N_FEATURES;
    const i64 p = pos[r];
    const int a = alt_code[r] & 3;
    const bool on = p >= 0 && p < g.length;
    const int rs = on ? min((int)g.ref[p], 3) : 0;
    T v[N_WINDOW][4];
#pragma unroll
    for (int w = 0; w < N_WINDOW; ++w) {
      const i64 q = p - HALF_WINDOW + w;
      load_row(counts, q >= 0 && q < g.length ? q : 0, v[w]);
    }
    float center[4] = {0.f, 0.f, 0.f, 0.f};
    float cdepth = 1.f;
#pragma unroll
    for (int w = 0; w < N_WINDOW; ++w) {
      const i64 q = p - HALF_WINDOW + w;
      const bool in = q >= 0 && q < g.length;
      float c[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) c[b] = in ? (float)v[w][b] : 0.f;
      const float d = ((c[0] + c[1]) + c[2]) + c[3];
      const float safe = fmaxf(d, 1.f);
#pragma unroll
      for (int b = 0; b < 4; ++b) f[4 * w + b] = c[b] / safe;
      f[DEPTH_COL + w] = fminf(d, 100.f) / 100.f;
      if (w == HALF_WINDOW) {
#pragma unroll
        for (int b = 0; b < 4; ++b) center[b] = c[b];
        cdepth = safe;
      }
    }
    float noise = 0.f, alt = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      f[ONEHOT_COL + b] = b == rs ? 1.f : 0.f;
      const float x = b == rs || b == a ? 0.f : center[b];
      noise = b == 0 ? x : fmaxf(noise, x);
      if (b == a) alt = center[b];
    }
    f[ONEHOT_COL + 4] = alt / cdepth;
    f[ONEHOT_COL + 5] = noise / cdepth;
  }
  __syncthreads();
  // the CTA's rows are out[r0 * 51, (r0 + n) * 51): 16-byte aligned, as
  // r0 * 51 * 4 is a multiple of 16 and the wrapper's output is aligned
  const int n_el = min(FEAT_THREADS, rows - r0) * N_FEATURES;
  float* dst = out + (i64)r0 * N_FEATURES;
  const int n4 = n_el / 4;
  for (int i = threadIdx.x; i < n4; i += FEAT_THREADS)
    reinterpret_cast<float4*>(dst)[i] =
        reinterpret_cast<const float4*>(tile)[i];
  for (int i = 4 * n4 + threadIdx.x; i < n_el; i += FEAT_THREADS)
    dst[i] = tile[i];
}

i64 ceil_div(i64 a, i64 b) { return (a + b - 1) / b; }

bool bad_counts(const void* counts, int count_bytes) {
  return (count_bytes != 4 && count_bytes != 8) || ((uintptr_t)counts & 15);
}

}  // namespace

extern "C" {

// The CTAs of the candidate passes over `length` positions.
int duet_snp_cand_ctas(long long length) {
  return (int)ceil_div(length, POS_PER_CTA);
}

// Scratch of the candidate passes, in int32s: the CTAs' counts, scanned in
// place (ctas + 1: the last is n), then a bit word a 32 positions.
long long duet_snp_cand_scratch(long long length) {
  const i64 ctas = ceil_div(length, POS_PER_CTA);
  return ctas + 1 + ctas * CAND_THREADS;
}

// The candidate bits of `counts` ((length, 4) int32 or int64, by
// count_bytes; 16-byte aligned) against `ref` (length uint8) into
// `scratch`; n lands at scratch[duet_snp_cand_ctas(length)].
int duet_snp_cand_count(const void* counts, int count_bytes, const void* ref,
                        long long length, long long min_depth,
                        long long min_alt, void* scratch, void* stream) {
  if (bad_counts(counts, count_bytes) || length < 1 || length >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int ctas = (int)ceil_div(length, POS_PER_CTA);
  int32_t* cta_n = (int32_t*)scratch;
  uint32_t* bits = (uint32_t*)(cta_n + ctas + 1);
  const Gate g{(const uint8_t*)ref, length, min_depth, min_alt};
  if (count_bytes == 4)
    cand_count<<<ctas, CAND_THREADS, 0, st>>>((const int32_t*)counts, g, bits,
                                              cta_n);
  else
    cand_count<<<ctas, CAND_THREADS, 0, st>>>((const i64*)counts, g, bits,
                                              cta_n);
  scan_kernel<<<1, SCAN_THREADS, 0, st>>>(cta_n, ctas);
  return (int)cudaGetLastError();
}

// The candidates' fields, n of each, from the scratch of
// duet_snp_cand_count on the same inputs.
int duet_snp_cand_compact(const void* counts, int count_bytes,
                          const void* ref, long long length,
                          long long min_depth, long long min_alt,
                          const void* scratch, void* pos, void* alt_code,
                          void* alt_count, void* depth, void* stream) {
  if (bad_counts(counts, count_bytes) || length < 1 || length >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int ctas = (int)ceil_div(length, POS_PER_CTA);
  const int32_t* offsets = (const int32_t*)scratch;
  const uint32_t* bits = (const uint32_t*)(offsets + ctas + 1);
  const Gate g{(const uint8_t*)ref, length, min_depth, min_alt};
  if (count_bytes == 4)
    cand_compact<<<ctas, CAND_THREADS, 0, st>>>(
        (const int32_t*)counts, g, bits, offsets, (i64*)pos,
        (uint8_t*)alt_code, (int32_t*)alt_count, (i64*)depth);
  else
    cand_compact<<<ctas, CAND_THREADS, 0, st>>>(
        (const i64*)counts, g, bits, offsets, (i64*)pos, (uint8_t*)alt_code,
        (int32_t*)alt_count, (i64*)depth);
  return (int)cudaGetLastError();
}

// The (rows, 51) float32 features (`out`, 16-byte aligned) of the `rows`
// candidates at `pos` (int64) with `alt_code` (uint8), as
// duet_snp_cand_compact wrote them.
int duet_snp_cand_features(const void* counts, int count_bytes,
                           const void* ref, long long length, const void* pos,
                           const void* alt_code, int rows, void* out,
                           void* stream) {
  if (bad_counts(counts, count_bytes) || length < 1 ||
      length >= (1ll << 31) || rows < 1 || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int ctas = (int)ceil_div(rows, FEAT_THREADS);
  const Gate g{(const uint8_t*)ref, length, 0, 0};
  if (count_bytes == 4)
    cand_features<<<ctas, FEAT_THREADS, 0, st>>>(
        (const int32_t*)counts, g, (const i64*)pos, (const uint8_t*)alt_code,
        rows, (float*)out);
  else
    cand_features<<<ctas, FEAT_THREADS, 0, st>>>(
        (const i64*)counts, g, (const i64*)pos, (const uint8_t*)alt_code,
        rows, (float*)out);
  return (int)cudaGetLastError();
}

const char* duet_snp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
