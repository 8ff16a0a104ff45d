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
// lanes hold it (zero-length ops own none; lanes past the ops' end belong
// to the last op); lanes at or past n_real do not count; the nibble's byte
// is read as a jnp gather reads payload[qidx >> 1]: a negative index i
// counts from the end (i + nb), then it is clamped to [0, nb - 1]; a
// nibble counts only if its base is < 4 and its bit 3 is set; a key
// outside [0, 4L) goes to the sentinel.  Keys are formed in 32-bit
// unsigned arithmetic and read back as int32, so a wrap gives JAX's value
// and is no C++ undefined behaviour.  Integer adds commute: the counts are
// the same whatever order the lanes land in.  The sentinel is not
// incremented lane by lane (every pad lane would hit one address): it
// starts at `total` and each CTA subtracts what it kept, so it ends at
// total minus the kept lanes, which is what the reference's scatter puts
// there.  Site calling follows call_sites: depth the sum of the four
// counts, ref_safe = min(ref, 3), alt the first maximum (strict > in
// column order) of the counts with the ref column set to -1, the
// allele-frequency cuts as int32 products (multiplied as uint32 and read
// back, so they wrap as JAX's do).  The compaction keeps position order;
// n_sites is the true count even past M, and each slot past the sites
// holds site_idx 0 and position 0's other four fields, as
// jnp.nonzero(fill_value=0) and the gathers give them.
//
// What bounds it.  Both are bound by bytes, each input read once and each
// output written once: the count by the payload's nibbles (half a byte a
// lane), the ops (12 bytes an op) and the histogram (16 bytes a position);
// the call by one read of the histogram and the reference codes (17 bytes
// a position) and its O(M) output.  At the smoke's grouped window (~200M
// lanes, L = 2^24) the count's is ~0.38 GB: ~0.11 ms at 3.35 TB/s.
//
// The count's design.  A global atomic a kept lane (the first version)
// runs at the atomics' rate, ~60 G/s, 30x the bytes' bound; so the counts
// are privatised per coordinate tile of TILE = 4096 positions, whose 4 x
// 4096 int32 counts (67,584 bytes with a pad word every 32) live in one
// CTA's dynamic shared memory.  That needs the ops binned by tile first:
//   op_block_sums  each 256-op block's length sum (and zeroes the tile
//                  counters, and sets the sentinel to `total`);
//   scan_kernel    the block sums; op_tiles then gives each op its first
//                  lane (block prefix + a scan in the block: a uint32
//                  exclusive scan of all K lengths), its lanes that can
//                  count, and the tiles they touch, counted per tile with
//                  one atomic a warp and tile (__match_any_sync); an op
//                  off the fast path (below) goes on a list instead;
//   scan_kernel    the tile counts, so each tile owns a slice of one list;
//   op_scatter     each op into the list of every tile it touches;
//   tile_count     one CTA a tile: zero the shared counts, walk each listed
//                  op's lanes clipped to the tile (a warp an op, 32-bit
//                  payload words, 8 nibbles each, 4 words in flight a
//                  thread; the ops of up to 32 entries fetched at once, one
//                  a lane, and passed round by shuffles), one shared atomic
//                  a kept lane, then every bin of the tile written once
//                  with 16-byte stores: no memset of the histogram, and no
//                  global atomic but one a CTA on the sentinel;
//   second_path    the listed ops that break the tile rule, lane by lane
//                  with global atomics, every rule above word for word.
// An op is on the fast path when each of its counting lanes has its key
// in [0, 4L) without a wrap (ref >= 0, ref + lanes <= L) and its nibble in
// [0, 2 nb) (q >= 0, q + lanes <= 2 nb): then no wrap, clamp or sentinel
// rule can apply.  The packers never make an op off it (a read past its
// contig raises before the upload, and the pad tail op's lanes are at or
// past n_real), so the second path launches a grid that finds an empty
// list.  Work a tile follows depth: a tile piled deeper takes longer.
// The list holds at most total / TILE + 2K entries (an op of n lanes
// touches at most n / TILE + 2 tiles).
//
// The call's design.  call_bits reads each position's four counts (one
// 16-byte load) and reference code once, calls it, and writes one bit a
// position (a __ballot_sync word for each 32) and each CTA's site count;
// one CTA scans the counts; compact_sites reads only the bit words (one a
// thread), ranks each site by __popc within its CTA's prefix, and reads
// again only the sites' counts and codes to write them.  Pass 1 moves the
// 17 bytes a position; pass 2 1/256 of that plus the sites.
//
// Built by nvcc into a shared library with a plain C interface
// (duet_tpu_torch/ops/cuda_build.py); each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OP_THREADS = 256;                    // op passes: an op a thread
constexpr int TILE = 4096;                         // positions a count tile
constexpr int TILE_ROW = TILE + TILE / 32;         // one base's shared counts
constexpr int TILE_SMEM = 4 * TILE_ROW * (int)sizeof(int32_t);
constexpr int TILE_THREADS = 512;
constexpr int TILE_WARPS = TILE_THREADS / 32;
// tile CTAs an SM holds: by shared memory (227 KB, 1 KB reserved a CTA)
// and by threads (2048)
constexpr int TILE_CTAS_SMEM = 232448 / (TILE_SMEM + 1024);
constexpr int TILE_CTAS = TILE_CTAS_SMEM < 2048 / TILE_THREADS
                              ? TILE_CTAS_SMEM : 2048 / TILE_THREADS;
constexpr int WORDS_AHEAD = 4;                     // loads in flight a thread
constexpr int SECOND_CTAS = 264;
constexpr int CALL_THREADS = 256;
constexpr int CALL_ROUNDS = 32;
constexpr int POS_PER_CTA = CALL_THREADS * CALL_ROUNDS;  // a bit word a thread
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

// The exclusive prefix of x over the CTA's threads; *total gets the sum.
// Every thread of the CTA must call it (it synchronises twice).
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

// ---------------------------------------------------------------- count --

using i64 = long long;

struct CountArgs {
  const int32_t* ref;  // ops4's rows: ref start, nibble start, length
  const int32_t* q;
  const int32_t* len;
  const int32_t* n_real;  // ops4[3, 0]
  const uint8_t* payload;
  int K, nb, total, length;
  bool aligned;  // payload 4-byte aligned
};

// The lanes that can count: [0, min(n_real, total)).
__device__ __forceinline__ int lane_limit(const CountArgs& a) {
  return min(max(*a.n_real, 0), a.total);
}

// Op k's lanes that can count, as its withins [w0, w1): lanes [s, next
// op's first) (to `limit` for the last op) clipped to [0, limit); and,
// when they are on the fast path, the tiles they touch.
struct Span {
  i64 w0, w1;
  int t0, nt;  // nt = 0 off the fast path or without lanes
  bool slow;   // lanes, off the fast path
};

__device__ Span op_span(int k, int32_t s, int limit, const CountArgs& a) {
  const i64 next = (int32_t)((uint32_t)s + (uint32_t)a.len[k]);
  const i64 lo = max((i64)s, 0ll);
  const i64 hi = k == a.K - 1 ? (i64)limit : min(next, (i64)limit);
  Span sp{lo - s, hi - s, 0, 0, false};
  if (hi <= lo) return sp;
  const i64 ref = a.ref[k], q = a.q[k];
  if (ref >= 0 && ref + sp.w1 <= a.length && q >= 0 &&
      q + sp.w1 <= 2 * (i64)a.nb) {
    sp.t0 = (int)((ref + sp.w0) / TILE);
    sp.nt = (int)((ref + sp.w1 - 1) / TILE) - sp.t0 + 1;
  } else {
    sp.slow = true;
  }
  return sp;
}

// The tiles t0 .. t0 + nt - 1 of each thread, a round a tile: the threads
// of a warp on one tile take consecutive slots of counter[t] with one
// atomic, and f(t, slot) runs for each.  Every thread of the warp calls it.
template <class F>
__device__ void tile_slots(int t0, int nt, int32_t* counter, F f) {
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  for (int j = 0; __any_sync(FULL, j < nt); ++j) {
    const int t = j < nt ? t0 + j : -1;
    const unsigned peers = __match_any_sync(FULL, t);
    if (t >= 0) {
      const int leader = __ffs(peers) - 1;
      int32_t slot = 0;
      if ((int)(threadIdx.x & 31) == leader)
        slot = atomicAdd(counter + t, __popc(peers));
      slot = __shfl_sync(peers, slot, leader);
      f(t, slot + __popc(peers & below));
    }
  }
}

// Each 256-op block's length sum (wrapping, as the reference's int32
// cumsum); also zeroes `zero[0, n_zero)` and sets the sentinel to total.
__global__ void __launch_bounds__(OP_THREADS)
    op_block_sums(const int32_t* __restrict__ len, int K,
                  int32_t* __restrict__ sums, int32_t* __restrict__ zero,
                  int n_zero, int32_t* __restrict__ sentinel, int total) {
  const int op = blockIdx.x * OP_THREADS + (int)threadIdx.x;
  for (int i = op; i < n_zero; i += gridDim.x * OP_THREADS) zero[i] = 0;
  if (op == 0) *sentinel = total;
  uint32_t sum;
  block_exclusive_scan<OP_THREADS>(op < K ? (uint32_t)len[op] : 0u, &sum);
  if (threadIdx.x == 0) sums[blockIdx.x] = (int32_t)sum;
}

// Each op's first lane; the fast ops' tiles counted per tile, the slow
// ops listed.
__global__ void __launch_bounds__(OP_THREADS)
    op_tiles(CountArgs a, const int32_t* __restrict__ sums,
             int32_t* __restrict__ first, int32_t* __restrict__ tile_n,
             int32_t* __restrict__ slow_n, int32_t* __restrict__ slow) {
  const int k = blockIdx.x * OP_THREADS + (int)threadIdx.x;
  uint32_t unused;
  const uint32_t s =
      (uint32_t)sums[blockIdx.x] +
      block_exclusive_scan<OP_THREADS>(k < a.K ? (uint32_t)a.len[k] : 0u,
                                       &unused);
  Span sp{0, 0, 0, 0, false};
  if (k < a.K) {
    first[k] = (int32_t)s;
    sp = op_span(k, (int32_t)s, lane_limit(a), a);
  }
  if (sp.slow) slow[atomicAdd(slow_n, 1)] = k;
  tile_slots(sp.t0, sp.nt, tile_n, [](int, int32_t) {});
}

// Each fast op into the list of every tile it touches.
__global__ void __launch_bounds__(OP_THREADS)
    op_scatter(CountArgs a, const int32_t* __restrict__ first,
               const int32_t* __restrict__ tile_off,
               int32_t* __restrict__ cursor, int32_t* __restrict__ list) {
  const int k = blockIdx.x * OP_THREADS + (int)threadIdx.x;
  Span sp{0, 0, 0, 0, false};
  if (k < a.K) sp = op_span(k, first[k], lane_limit(a), a);
  tile_slots(sp.t0, sp.nt, cursor,
             [&](int t, int32_t slot) { list[tile_off[t] + slot] = k; });
}

// Payload word x (nibbles 8x .. 8x + 7); bytes at or past nb read as 0.
__device__ __forceinline__ uint32_t load_word(const CountArgs& a,
                                              uint32_t x) {
  const uint64_t b = (uint64_t)x * 4;
  if (a.aligned && b + 4 <= (uint64_t)a.nb)
    return __ldg(reinterpret_cast<const uint32_t*>(a.payload) + x);
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (b + i < (uint64_t)a.nb) w |= (uint32_t)a.payload[b + i] << (8 * i);
  return w;
}

__device__ __forceinline__ int smem_at(uint32_t base, uint32_t pos) {
  return (int)(base * TILE_ROW + pos + (pos >> 5));
}

// One CTA a tile: its listed ops' lanes counted in shared memory, then
// the tile's bins written once.
__global__ void __launch_bounds__(TILE_THREADS, TILE_CTAS)
    tile_count(CountArgs a, const int32_t* __restrict__ first,
               const int32_t* __restrict__ tile_off,
               const int32_t* __restrict__ list, int32_t* __restrict__ bins) {
  extern __shared__ int4 smem4[];
  int32_t* counts = reinterpret_cast<int32_t*>(smem4);
  for (int i = threadIdx.x; i < TILE_ROW; i += TILE_THREADS)
    smem4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int limit = lane_limit(a);
  const i64 p0 = (i64)blockIdx.x * TILE;
  const int e_end = tile_off[blockIdx.x + 1];
  uint32_t kept = 0;
  for (int eb = tile_off[blockIdx.x] + warp; eb < e_end;
       eb += 32 * TILE_WARPS) {
    // lane i fetches entry eb + i * TILE_WARPS: its nibbles in the tile,
    // [n0, n1), and the shift from a nibble index to a tile position
    const int e = eb + lane * TILE_WARPS;
    uint32_t my_n0 = 0, my_n1 = 0, my_shift = 0;
    if (e < e_end) {
      const int k = list[e];
      const Span sp = op_span(k, first[k], limit, a);
      const i64 ref = a.ref[k], q = a.q[k];
      const i64 w0 = max(sp.w0, p0 - ref);
      const i64 w1 = min(sp.w1, p0 + TILE - ref);
      my_n0 = (uint32_t)(q + w0);
      my_n1 = (uint32_t)(q + w1);
      my_shift = (uint32_t)(ref - p0 - q);
    }
    const int n_here = min(32, (e_end - eb + TILE_WARPS - 1) / TILE_WARPS);
    for (int i = 0; i < n_here; ++i) {
      const uint32_t n0 = __shfl_sync(FULL, my_n0, i);
      const uint32_t n1 = __shfl_sync(FULL, my_n1, i);
      const uint32_t shift = __shfl_sync(FULL, my_shift, i);
      const uint32_t x1 = (n1 - 1) >> 3;  // last word, inclusive
      for (uint32_t x0 = (n0 >> 3) + lane; x0 <= x1; x0 += 32 * WORDS_AHEAD) {
        uint32_t w[WORDS_AHEAD];
#pragma unroll
        for (int u = 0; u < WORDS_AHEAD; ++u) {
          const uint32_t x = x0 + 32u * u;
          w[u] = x <= x1 ? load_word(a, x) : 0u;
        }
#pragma unroll
        for (int u = 0; u < WORDS_AHEAD; ++u) {
          const uint32_t nx = (x0 + 32u * u) * 8u;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint32_t n = nx + j, nib = (w[u] >> (4 * j)) & 15u;
            if (n >= n0 && n < n1 && (nib & 8u) && (nib & 7u) < 4u) {
              atomicAdd(counts + smem_at(nib & 7u, n + shift), 1);
              ++kept;
            }
          }
        }
      }
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < TILE && p0 + p < a.length;
       p += TILE_THREADS) {
    const int i = smem_at(0, p);
    reinterpret_cast<int4*>(bins)[p0 + p] =
        make_int4(counts[i], counts[i + TILE_ROW], counts[i + 2 * TILE_ROW],
                  counts[i + 3 * TILE_ROW]);
  }
  uint32_t cta_kept;
  block_exclusive_scan<TILE_THREADS>(kept, &cta_kept);
  if (threadIdx.x == 0 && cta_kept)
    atomicAdd(reinterpret_cast<unsigned int*>(bins + 4 * a.length),
              0u - cta_kept);
}

// The ops off the fast path, a CTA an op, lane by lane with global
// atomics (after tile_count, on the same stream).
__global__ void __launch_bounds__(OP_THREADS)
    second_path(CountArgs a, const int32_t* __restrict__ first,
                const int32_t* __restrict__ slow_n,
                const int32_t* __restrict__ slow, int32_t* __restrict__ bins) {
  const int n = *slow_n, limit = lane_limit(a), sentinel = 4 * a.length;
  uint32_t kept = 0;
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const int k = slow[i];
    const Span sp = op_span(k, first[k], limit, a);
    const uint32_t ref = (uint32_t)a.ref[k], q = (uint32_t)a.q[k];
    for (i64 w = sp.w0 + threadIdx.x; w < sp.w1; w += OP_THREADS) {
      const uint32_t within = (uint32_t)w;
      const int32_t qidx = (int32_t)(q + within);
      int32_t at = qidx >> 1;
      if (at < 0) at += a.nb;  // a jnp gather: from the end, then clamped
      at = min(max(at, 0), a.nb - 1);
      const int nib = (a.payload[at] >> ((qidx & 1) << 2)) & 0xF;
      const int base = nib & 7;
      if (base < 4 && (nib & 8)) {
        const int32_t key = (int32_t)((ref + within) * 4u + (uint32_t)base);
        if (key >= 0 && key < sentinel) {
          atomicAdd(&bins[key], 1);
          ++kept;
        }
      }
    }
  }
  uint32_t cta_kept;
  block_exclusive_scan<OP_THREADS>(kept, &cta_kept);
  if (threadIdx.x == 0 && cta_kept)
    atomicAdd(reinterpret_cast<unsigned int*>(bins + sentinel),
              0u - cta_kept);
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

// Pass 1: a site bit a position (a ballot word for each 32) and each
// CTA's count of sites over its POS_PER_CTA positions.
__global__ void __launch_bounds__(CALL_THREADS)
    call_bits(const int32_t* __restrict__ bins,
              const uint8_t* __restrict__ ref, int length,
              const int32_t* __restrict__ params,
              uint32_t* __restrict__ bits, int32_t* __restrict__ counts) {
  const Params q = load_params(params);
  const int p0 = blockIdx.x * POS_PER_CTA;
  const int warp_p0 = p0 + (int)(threadIdx.x & ~31u);
  uint32_t s = 0;
#pragma unroll 8
  for (int k = 0; k < CALL_ROUNDS; ++k) {
    const int p = p0 + k * CALL_THREADS + (int)threadIdx.x;
    const uint32_t word =
        __ballot_sync(FULL, p < length && call_at(bins, ref, p, q).site);
    if ((threadIdx.x & 31) == 0) {
      bits[(warp_p0 + k * CALL_THREADS) >> 5] = word;
      s += __popc(word);
    }
  }
  uint32_t total;
  block_exclusive_scan<CALL_THREADS>(s, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = (int32_t)total;
}

// Pass 2: a bit word a thread; each site to its slot (its CTA's first
// slot, the CTA's sites in the words before, the bits below it), while
// the slot is below M; then the slots past the sites.
__global__ void __launch_bounds__(CALL_THREADS)
    compact_sites(const int32_t* __restrict__ bins,
                  const uint8_t* __restrict__ ref,
                  const int32_t* __restrict__ params,
                  const uint32_t* __restrict__ bits,
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
  const int wi = blockIdx.x * CALL_THREADS + (int)threadIdx.x;
  uint32_t word = bits[wi], unused;
  uint32_t slot = (uint32_t)offsets[blockIdx.x] +
                  block_exclusive_scan<CALL_THREADS>(__popc(word), &unused);
  for (; word && slot < (uint32_t)M; word &= word - 1, ++slot) {
    const int p = wi * 32 + __ffs(word) - 1;
    const Call c = call_at(bins, ref, p, q);
    site_idx[slot] = p;
    alt_code[slot] = c.alt;
    is_het[slot] = c.het;
    depth[slot] = c.depth;
    alt_count[slot] = c.alt_count;
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

int ceil_div(i64 a, i64 b) { return (int)((a + b - 1) / b); }

}  // namespace

extern "C" {

int duet_pileup_count_tile(void) { return TILE; }

// Scratch each entry needs, in int32s.  The count's, in order: [0] the
// number of ops off the fast path; the tiles' counts, scanned in place
// (n_tiles + 1: the last the list's length); the tiles' cursors
// (n_tiles); the op blocks' sums (+ 1); the ops' first lanes (K); the ops
// off the fast path (K); the tiles' lists (total / TILE + 2K).
long long duet_pileup_count_scratch(int K, int total, int length) {
  const i64 n_tiles = ceil_div(length, TILE);
  return 1 + 2 * n_tiles + 1 + ceil_div(K, OP_THREADS) + 1 + 2 * (i64)K +
         total / TILE + 2 * (i64)K;
}

int duet_pileup_call_scratch(int length) {
  const int ctas = ceil_div(length, POS_PER_CTA);
  return ctas + 1 + ctas * CALL_THREADS;
}

// Count the `total` lanes of the ops into `bins` ((4 * length + 1) int32,
// 16-byte aligned; every bin is written) on `stream` (a cudaStream_t).
// `scratch` holds duet_pileup_count_scratch(K, total, length) int32s.
// Returns the first CUDA error as an int (0 on success).
int duet_pileup_count(const void* ops4, int K, const void* payload, int nb,
                      int total, int length, void* bins, void* scratch,
                      void* stream) {
  if (K < 1 || nb < 1 || total < 0 || length < 1 || length > (1 << 28) ||
      ((uintptr_t)bins & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int32_t* ops = (const int32_t*)ops4;
  const int n_tiles = ceil_div(length, TILE);
  const int op_ctas = ceil_div(K, OP_THREADS);
  int32_t* slow_n = (int32_t*)scratch;
  int32_t* tile_off = slow_n + 1;
  int32_t* cursor = tile_off + n_tiles + 1;
  int32_t* sums = cursor + n_tiles;
  int32_t* first = sums + op_ctas + 1;
  int32_t* slow = first + K;
  int32_t* list = slow + K;
  int32_t* out = (int32_t*)bins;
  cudaError_t err = cudaFuncSetAttribute(
      tile_count, cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_SMEM);
  if (err != cudaSuccess) return (int)err;
  const CountArgs a{ops, ops + K, ops + 2 * (size_t)K, ops + 3 * (size_t)K,
                    (const uint8_t*)payload, K, nb, total, length,
                    ((uintptr_t)payload & 3) == 0};
  op_block_sums<<<op_ctas, OP_THREADS, 0, st>>>(a.len, K, sums, slow_n,
                                                2 + 2 * n_tiles,
                                                out + 4 * length, total);
  scan_kernel<<<1, SCAN_THREADS, 0, st>>>(sums, op_ctas);
  op_tiles<<<op_ctas, OP_THREADS, 0, st>>>(a, sums, first, tile_off, slow_n,
                                           slow);
  scan_kernel<<<1, SCAN_THREADS, 0, st>>>(tile_off, n_tiles);
  op_scatter<<<op_ctas, OP_THREADS, 0, st>>>(a, first, tile_off, cursor,
                                             list);
  tile_count<<<n_tiles, TILE_THREADS, TILE_SMEM, st>>>(a, first, tile_off,
                                                       list, out);
  second_path<<<SECOND_CTAS, OP_THREADS, 0, st>>>(a, first, slow_n, slow,
                                                  out);
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
  const int ctas = ceil_div(length, POS_PER_CTA);
  int32_t* offsets = (int32_t*)scratch;
  uint32_t* bits = (uint32_t*)(offsets + ctas + 1);
  call_bits<<<ctas, CALL_THREADS, 0, st>>>(
      (const int32_t*)bins, (const uint8_t*)ref, length,
      (const int32_t*)params, bits, offsets);
  scan_kernel<<<1, SCAN_THREADS, 0, st>>>(offsets, ctas);
  compact_sites<<<ctas, CALL_THREADS, 0, st>>>(
      (const int32_t*)bins, (const uint8_t*)ref, (const int32_t*)params,
      bits, offsets, ctas, max_sites, (int32_t*)out);
  return (int)cudaGetLastError();
}

const char* duet_pileup_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
