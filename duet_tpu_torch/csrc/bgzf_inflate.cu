// The BAM's BGZF members inflated on the card, for Hopper (sm_90a): a
// DEFLATE decoder written by hand, one warp a member, with each member's
// gzip trailer (CRC32 and byte count) checked on the card.
//
// It replaces no TPU kernel: duet_tpu inflates on the host (zlib or
// libdeflate in native/duet_ingest.cc's thread pool), and so does the
// port's reader (csrc/duet_ingest.cc) without a card.  A BGZF member is an
// independent gzip stream of at most 64 KB whose back-references never
// leave it, so every member of a batch can decode at once: the reader
// hands the card a batch of whole members through duet_bgzf_inflate (its
// inflater hook, duet_bam_set_inflater) and scans the inflated bytes as
// before.
//
// What bounds it, and what the design does about each:
//   * bytes over PCIe.  The compressed batch goes up and the inflated
//     bytes come back (at the q10-10x cell's ratio, 1.64 bytes down for
//     each byte up), through the driver's staging: each file read's
//     whole members go up as the reader reads on (so its compressed
//     window stays as small as the zlib pool's), the batch's output comes
//     back in one copy, and while the card decodes, -t threads fault in
//     the fresh pages of the reader's window, which the copy back would
//     otherwise touch one at a time.
//   * the serial decode of the longest member.  Huffman decoding is
//     sequential within a member, so one lane of the warp decodes while
//     the SM runs the other members' warps: every member of a batch is
//     resident at once (about 25 KB of shared memory for four warps).
//     Each symbol is one lookup of a 10-bit primary table in shared memory
//     (8 bits for distances); the rare longer codes walk the canonical
//     code a bit at a time.  The decoding lane stages literals in shared
//     memory and queues matches (in BAM data nearly half the symbols,
//     3.6 bytes long on average, half of them from farther back than the
//     stage holds).  Then the lanes take the matches whose sources all lie
//     in device memory, one a lane at once (an overlapping match,
//     distance < length, copies byte j from dst - distance + j mod
//     distance), one lane resolves the rest in order from shared memory,
//     and the warp stores the staged bytes to device memory coalesced.
//     The warp also builds the canonical decode tables (ranks by
//     __match_any_sync) and copies stored blocks.
//   * device memory: the compressed bytes are read once (read-only,
//     cached) and the output written once and read once more for the
//     CRC32: each lane takes a 32nd of the member, table-driven, and the
//     warp combines the lanes' CRCs (zlib's crc32_combine, GF(2)).
//
// The checks are zlib's gzip-mode checks, so the card accepts what the
// host route accepts: the header (ID, CM 8, no reserved flag, FEXTRA,
// FNAME, FCOMMENT, FHCRC against the header's CRC32), each block (type,
// stored LEN against NLEN, at most 286 literal/length and 30 distance
// codes, code-length repeats, no over-subscribed code, no incomplete code
// but a single one-bit literal/length or distance code, an end-of-block
// code, no distance past the member's start, no symbol 286-287 or
// distance 30-31), the input (no bit read past the member), and the
// trailer right after the last block: CRC32 of the output, ISIZE equal to
// the bytes decoded, and those equal to the reader's ISIZE from the
// member table.  Each member's status goes to `status`; the batch's worst
// to status[n].
//
// Built by nvcc into a shared library with a plain C interface
// (duet_tpu_torch/ops/cuda_build.py); entries that launch return the
// launch's cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <string>
#include <thread>
#include <vector>

namespace {

using i64 = long long;

constexpr int WARPS = 4;                  // members a CTA, a warp each
constexpr int THREADS = WARPS * 32;
constexpr int LIT_BITS = 10;              // primary table of literal/lengths
constexpr int DIST_BITS = 8;              // and of distances
constexpr int CL_BITS = 7;                // code-length codes: all fit
constexpr int STAGE = 2048;               // output bytes a warp stages a round
constexpr int MAX_OPS = 64;               // matches a round
constexpr int MAX_MATCH = 258;
constexpr unsigned FULL = 0xffffffffu;

// member statuses (ops/bgzf_inflate.py STATUS)
constexpr int OK = 0;
constexpr int BAD_DATA = 1;     // the DEFLATE data
constexpr int BAD_HEADER = 2;   // the gzip header
constexpr int BAD_CRC = 3;      // CRC32 of the output against the trailer's
constexpr int BAD_SIZE = 4;     // bytes decoded against ISIZE or the table

__constant__ uint16_t kLenBase[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
    35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
__constant__ uint8_t kLenExtra[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
    3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ uint16_t kDistBase[30] = {
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
    257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
    16385, 24577};
__constant__ uint8_t kDistExtra[30] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
    7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
__constant__ uint8_t kClOrder[19] = {
    16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
// x^(2^k) mod the CRC-32 polynomial, reflected (zlib's x2n_table)
__constant__ uint32_t kX2n[32] = {
    0x40000000u, 0x20000000u, 0x08000000u, 0x00800000u, 0x00008000u,
    0xedb88320u, 0xb1e6b092u, 0xa06a2517u, 0xed627daeu, 0x88d14467u,
    0xd7bbfe6au, 0xec447f11u, 0x8e7ea170u, 0x6427800eu, 0x4d47bae0u,
    0x09fe548fu, 0x83852d0fu, 0x30362f1au, 0x7b5a9cc3u, 0x31fec169u,
    0x9fec022au, 0x6c8dedc4u, 0x15d6874du, 0x5fde7a4eu, 0xbad90e37u,
    0x2e4e5eefu, 0x4eaba214u, 0xa8a472c0u, 0x429a969eu, 0x148d302au,
    0xc40ba6d0u, 0xc4e22c3cu};
constexpr uint32_t kPoly = 0xedb88320u;

struct Op {              // a queued match: stage offset, length, distance
  uint16_t dst, len, dist;
};

// one warp's shared memory
struct alignas(16) WarpSmem {
  uint8_t stage[STAGE];
  uint16_t lit[1 << LIT_BITS];   // (length << 9) | symbol; 0: longer code
  uint16_t dist[1 << DIST_BITS];
  uint16_t lit_sorted[288];      // symbols by (length, symbol)
  uint16_t dist_sorted[32];
  uint16_t lit_count[16];        // codes of each length
  uint16_t dist_count[16];
  uint16_t first[16];            // while building: first code of a length,
  uint16_t offs[16];             // its first index in sorted,
  uint16_t rank[16];             // and the symbols ranked so far
  uint8_t lens[320];             // code lengths: literal/length, distance
  Op ops[MAX_OPS];
};

// LSB-first bit reader over one member, on the decoding lane; it loads
// aligned 32-bit words and reads zeros past the member's last word
struct Bits {
  const uint32_t* wp;
  const uint32_t* wend;
  const uint8_t* begin;
  uint64_t buf;
  int n;

  __device__ void init(const uint8_t* p, const uint8_t* member,
                       const uint8_t* end) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    begin = member;
    wp = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    wend = reinterpret_cast<const uint32_t*>(
        (reinterpret_cast<uintptr_t>(end) + 3) & ~uintptr_t(3));
    buf = 0;
    n = 0;
    refill();
    const int skip = static_cast<int>(a & 3) * 8;
    buf >>= skip;
    n -= skip;
  }
  // at least 32 bits in buf
  __device__ __forceinline__ void refill() {
    if (n <= 32) {
      const uint32_t v = wp < wend ? __ldg(wp) : 0u;
      buf |= static_cast<uint64_t>(v) << n;
      n += 32;
      ++wp;
    }
  }
  __device__ __forceinline__ uint32_t peek(int k) const {
    return static_cast<uint32_t>(buf) & ((1u << k) - 1u);
  }
  __device__ __forceinline__ void drop(int k) {
    buf >>= k;
    n -= k;
  }
  __device__ __forceinline__ uint32_t take(int k) {
    const uint32_t v = peek(k);
    drop(k);
    return v;
  }
  // bits read since the member's first byte
  __device__ i64 consumed() const {
    return (reinterpret_cast<const uint8_t*>(wp) - begin) * 8ll - n;
  }
  // the next unread byte, once byte-aligned
  __device__ const uint8_t* pos() const {
    return reinterpret_cast<const uint8_t*>(wp) - n / 8;
  }
};

__device__ uint32_t mult_mod_p(uint32_t a, uint32_t b) {
  uint32_t m = 1u << 31, p = 0;
  for (int i = 0; i < 32; ++i) {
    if (a & m) p ^= b;
    m >>= 1;
    b = (b & 1) ? (b >> 1) ^ kPoly : b >> 1;
  }
  return p;
}

// zlib's crc32_combine: the CRC32 of A then B from theirs and B's length
__device__ uint32_t crc32_combine(uint32_t crc_a, uint32_t crc_b,
                                  uint32_t len_b) {
  uint32_t p = 1u << 31;   // x^0
  for (int k = 3; len_b; len_b >>= 1, ++k)
    if (len_b & 1) p = mult_mod_p(kX2n[k & 31], p);
  return mult_mod_p(p, crc_a) ^ crc_b;
}

__device__ uint32_t crc32_bytes(const uint32_t* table, const uint8_t* p,
                                int len, uint32_t c = 0xffffffffu) {
  for (int i = 0; i < len; ++i) c = table[(c ^ p[i]) & 0xff] ^ (c >> 8);
  return c;
}

// Canonical decode tables of the code lengths lens[0..n) (the whole warp):
// the primary `table` of 2^bits entries, `count` and `sorted` for the
// longer codes.  False where zlib refuses the lengths: an over-subscribed
// code, or an incomplete one but (not `codes`) a single one-bit code.
__device__ bool build_code(WarpSmem& w, const uint8_t* lens, int n,
                           uint16_t* table, int bits, uint16_t* count,
                           uint16_t* sorted, bool codes, int lane) {
  if (lane < 16) {
    count[lane] = 0;
    w.rank[lane] = 0;
  }
  __syncwarp();
  for (int g = 0; g < n; g += 32) {
    const int s = g + lane;
    const int l = s < n ? lens[s] : 0;
    const unsigned m = __match_any_sync(FULL, l);
    if (l && lane == __ffs(m) - 1) count[l] += __popc(m);
    __syncwarp();
  }
  int ok = 1;
  if (lane == 0) {
    int left = 1, max_len = 0, code = 0, off = 0;
    for (int len = 1; len < 16; ++len) {   // count[0] is 0
      left = (left << 1) - count[len];
      if (left < 0) ok = 0;
      if (count[len]) max_len = len;
      code = (code + count[len - 1]) << 1;
      w.first[len] = static_cast<uint16_t>(code);
      w.offs[len] = static_cast<uint16_t>(off);
      off += count[len];
    }
    if (max_len && left > 0 && (codes || max_len != 1)) ok = 0;
  }
  ok = __shfl_sync(FULL, ok, 0);
  if (!ok) return false;
  for (int e = lane; e < (1 << bits); e += 32) table[e] = 0;
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  for (int g = 0; g < n; g += 32) {
    const int s = g + lane;
    const int l = s < n ? lens[s] : 0;
    const unsigned m = __match_any_sync(FULL, l);
    if (l) {
      const int r = w.rank[l] + __popc(m & below);
      sorted[w.offs[l] + r] = static_cast<uint16_t>(s);
      if (l <= bits) {
        const uint32_t rev = __brev(static_cast<uint32_t>(w.first[l] + r))
                             >> (32 - l);
        const uint16_t e = static_cast<uint16_t>((l << 9) | s);
        for (uint32_t i = rev; i < (1u << bits); i += 1u << l) table[i] = e;
      }
    }
    __syncwarp();
    if (l && lane == __ffs(m) - 1) w.rank[l] += __popc(m);
    __syncwarp();
  }
  return true;
}

// One symbol (the decoding lane; at least 15 bits in the reader); -1 where
// the bits begin no code.
__device__ __forceinline__ int decode_sym(Bits& br, const uint16_t* table,
                                          int bits, const uint16_t* count,
                                          const uint16_t* sorted) {
  const uint16_t e = table[br.peek(bits)];
  if (e) {
    br.drop(e >> 9);
    return e & 511;
  }
  int code = 0, first = 0, index = 0;
  for (int len = 1; len < 16; ++len) {
    code |= static_cast<int>((br.buf >> (len - 1)) & 1);
    const int c = count[len];
    if (code - c < first) {
      br.drop(len);
      return sorted[index + code - first];
    }
    index += c;
    first = (first + c) << 1;
    code <<= 1;
  }
  return -1;
}

// The gzip header of a member (the decoding lane): its length, or -1.
__device__ int parse_header(const uint8_t* p, int size,
                            const uint32_t* crc_table) {
  if (size < 18 || p[0] != 0x1f || p[1] != 0x8b || p[2] != 8) return -1;
  const int flg = p[3];
  if (flg & 0xe0) return -1;
  int i = 10;
  if (flg & 4) {
    i += 2 + (p[10] | (p[11] << 8));
    if (i > size) return -1;
  }
  for (int bit = 8; bit <= 16; bit <<= 1) {   // FNAME, FCOMMENT
    if (!(flg & bit)) continue;
    while (i < size && p[i]) ++i;
    if (++i > size) return -1;
  }
  if (flg & 2) {
    if (i + 2 > size) return -1;
    const uint32_t crc = ~crc32_bytes(crc_table, p, i);
    if ((crc & 0xffff) != static_cast<uint32_t>(p[i] | (p[i + 1] << 8)))
      return -1;
    i += 2;
  }
  return i;
}

// One Huffman-coded block's data with the tables built (the whole warp);
// `out_pos` advances by the bytes written.
__device__ int huffman_block(WarpSmem& w, Bits& br, int in_size,
                             uint8_t* out, int out_size, int& out_pos,
                             int lane) {
  while (true) {
    int fill = 0, n_ops = 0, eob = 0, err = OK;
    if (lane == 0) {
      while (fill + MAX_MATCH <= STAGE && n_ops < MAX_OPS) {
        br.refill();
        int sym = decode_sym(br, w.lit, LIT_BITS, w.lit_count, w.lit_sorted);
        if (sym < 256) {
          if (sym < 0) { err = BAD_DATA; break; }
          if (out_pos + fill >= out_size) { err = BAD_SIZE; break; }
          w.stage[fill++] = static_cast<uint8_t>(sym);
          continue;
        }
        if (sym == 256) { eob = 1; break; }
        sym -= 257;
        if (sym >= 29) { err = BAD_DATA; break; }
        const int len = kLenBase[sym] + br.take(kLenExtra[sym]);
        br.refill();
        const int ds = decode_sym(br, w.dist, DIST_BITS, w.dist_count,
                                  w.dist_sorted);
        if (ds < 0 || ds >= 30) { err = BAD_DATA; break; }
        const int dist = kDistBase[ds] + br.take(kDistExtra[ds]);
        if (dist > out_pos + fill) { err = BAD_DATA; break; }
        if (out_pos + fill + len > out_size) { err = BAD_SIZE; break; }
        w.ops[n_ops++] = {static_cast<uint16_t>(fill),
                          static_cast<uint16_t>(len),
                          static_cast<uint16_t>(dist)};
        fill += len;
      }
      if (!err && br.consumed() > in_size * 8ll) err = BAD_DATA;
    }
    __syncwarp();
    err = __shfl_sync(FULL, err, 0);
    if (err) return err;
    fill = __shfl_sync(FULL, fill, 0);
    n_ops = __shfl_sync(FULL, n_ops, 0);
    eob = __shfl_sync(FULL, eob, 0);
    // matches whose every source byte precedes the stage (in device
    // memory, final) need nothing of this round: one a lane, at once
    for (int k = lane; k < n_ops; k += 32) {
      const Op op = w.ops[k];
      if (op.dst - op.dist + min(op.len, op.dist) > 0) continue;
      const int base = out_pos + op.dst - op.dist;
      for (int j = 0; j < op.len; ++j)
        w.stage[op.dst + j] = out[base + (j < op.dist ? j : j % op.dist)];
    }
    __syncwarp();
    // the others in order on one lane: each reads only bytes before it,
    // literals, those matches, or the others before it
    if (lane == 0) {
      for (int k = 0; k < n_ops; ++k) {
        const Op op = w.ops[k];
        if (op.dst - op.dist + min(op.len, op.dist) <= 0) continue;
        for (int j = 0; j < op.len; ++j) {
          const int src = op.dst + j - op.dist;
          w.stage[op.dst + j] = src >= 0 ? w.stage[src] : out[out_pos + src];
        }
      }
    }
    __syncwarp();
    for (int j = lane; j < fill; j += 32) out[out_pos + j] = w.stage[j];
    out_pos += fill;
    __syncwarp();
    if (eob) return OK;
  }
}

// One whole member (the whole warp): its status.
__device__ int inflate_member(WarpSmem& w, const uint32_t* crc_table,
                              const uint8_t* in, int in_size, uint8_t* out,
                              int out_size, int lane) {
  Bits br = {};
  int err = OK;
  if (lane == 0) {
    const int hdr = parse_header(in, in_size, crc_table);
    if (hdr < 0) err = BAD_HEADER;
    else br.init(in + hdr, in, in + in_size);
  }
  err = __shfl_sync(FULL, err, 0);
  int out_pos = 0;
  int last = 0;
  while (!err && !last) {
    int type = 0;
    if (lane == 0) {
      br.refill();
      last = br.take(1);
      type = br.take(2);
    }
    last = __shfl_sync(FULL, last, 0);
    type = __shfl_sync(FULL, type, 0);
    if (type == 0) {                         // stored
      int src = 0, len = 0;
      if (lane == 0) {
        br.drop(br.n & 7);
        br.refill();
        len = br.take(16);
        const uint32_t nlen = br.take(16);
        src = static_cast<int>(br.pos() - in);
        if (nlen != (~static_cast<uint32_t>(len) & 0xffff) ||
            src + len > in_size)
          err = BAD_DATA;
        else if (out_pos + len > out_size)
          err = BAD_SIZE;
        else
          br.init(in + src + len, in, in + in_size);
      }
      err = __shfl_sync(FULL, err, 0);
      if (err) break;
      src = __shfl_sync(FULL, src, 0);
      len = __shfl_sync(FULL, len, 0);
      for (int j = lane; j < len; j += 32) out[out_pos + j] = in[src + j];
      out_pos += len;
      __syncwarp();
      continue;
    }
    if (type == 3) { err = BAD_DATA; break; }
    int nlen = 288, ndist = 32;
    if (type == 1) {                         // fixed codes
      for (int s = lane; s < 320; s += 32)
        w.lens[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : s < 288 ? 8 : 5;
    } else {                                 // dynamic codes
      if (lane == 0) {
        br.refill();
        nlen = br.take(5) + 257;
        ndist = br.take(5) + 1;
        const int ncode = br.take(4) + 4;
        if (nlen > 286 || ndist > 30) err = BAD_DATA;
        for (int i = 0; i < 19; ++i) {
          br.refill();
          w.lens[kClOrder[i]] = i < ncode ? br.take(3) : 0;
        }
      }
      __syncwarp();
      err = __shfl_sync(FULL, err, 0);
      if (err) break;
      nlen = __shfl_sync(FULL, nlen, 0);
      ndist = __shfl_sync(FULL, ndist, 0);
      // the code-length code borrows the literal/length tables
      if (!build_code(w, w.lens, 19, w.lit, CL_BITS, w.lit_count,
                      w.lit_sorted, true, lane)) {
        err = BAD_DATA;
        break;
      }
      if (lane == 0) {
        const int total = nlen + ndist;
        int i = 0;
        while (i < total) {
          br.refill();
          const int sym = decode_sym(br, w.lit, CL_BITS, w.lit_count,
                                     w.lit_sorted);
          if (sym < 0) { err = BAD_DATA; break; }
          if (sym < 16) {
            w.lens[i++] = static_cast<uint8_t>(sym);
            continue;
          }
          int len = 0, rep;
          if (sym == 16) {
            if (i == 0) { err = BAD_DATA; break; }
            len = w.lens[i - 1];
            rep = 3 + br.take(2);
          } else if (sym == 17) {
            rep = 3 + br.take(3);
          } else {
            rep = 11 + br.take(7);
          }
          if (i + rep > total) { err = BAD_DATA; break; }
          while (rep--) w.lens[i++] = static_cast<uint8_t>(len);
        }
        if (!err && w.lens[256] == 0) err = BAD_DATA;
        if (!err && br.consumed() > in_size * 8ll) err = BAD_DATA;
      }
      __syncwarp();
      err = __shfl_sync(FULL, err, 0);
      if (err) break;
    }
    __syncwarp();
    if (!build_code(w, w.lens, nlen, w.lit, LIT_BITS, w.lit_count,
                    w.lit_sorted, false, lane) ||
        !build_code(w, w.lens + nlen, ndist, w.dist, DIST_BITS, w.dist_count,
                    w.dist_sorted, false, lane)) {
      err = BAD_DATA;
      break;
    }
    err = huffman_block(w, br, in_size, out, out_size, out_pos, lane);
  }
  // the trailer right after the last block, as zlib reads it
  uint32_t want_crc = 0, isize = 0;
  if (!err && lane == 0) {
    br.drop(br.n & 7);
    const uint8_t* t = br.pos();
    if (br.consumed() > in_size * 8ll || t + 8 > in + in_size) {
      err = BAD_DATA;
    } else {
      want_crc = t[0] | (t[1] << 8) | (t[2] << 16) |
                 (static_cast<uint32_t>(t[3]) << 24);
      isize = t[4] | (t[5] << 8) | (t[6] << 16) |
              (static_cast<uint32_t>(t[7]) << 24);
    }
  }
  err = __shfl_sync(FULL, err, 0);
  if (err) return err;
  // CRC32 of the output: a 32nd a lane, combined across the warp
  const int chunk = (out_pos + 31) / 32;
  const int lo = min(out_pos, lane * chunk);
  const int hi = min(out_pos, lo + chunk);
  uint32_t crc = ~crc32_bytes(crc_table, out + lo, hi - lo);
  uint32_t len = static_cast<uint32_t>(hi - lo);
  for (int s = 1; s < 32; s <<= 1) {
    const uint32_t oc = __shfl_down_sync(FULL, crc, s);
    const uint32_t ol = __shfl_down_sync(FULL, len, s);
    if ((lane & (2 * s - 1)) == 0) {
      crc = crc32_combine(crc, oc, ol);
      len += ol;
    }
  }
  if (lane == 0) {
    if (crc != want_crc) err = BAD_CRC;
    else if (isize != static_cast<uint32_t>(out_pos) || out_pos != out_size)
      err = BAD_SIZE;
  }
  return __shfl_sync(FULL, err, 0);
}

// table: n rows of (in_off, in_size, out_off, out_size), offsets into comp
// and out; status: n + 1 int32, the last the batch's worst (zeroed by the
// caller)
__global__ void __launch_bounds__(THREADS)
bgzf_inflate_kernel(const uint8_t* comp, const i64* table, i64 n,
                    uint8_t* out, int32_t* status) {
  __shared__ WarpSmem warps[WARPS];
  __shared__ uint32_t crc_table[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    uint32_t c = static_cast<uint32_t>(i);
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ kPoly : c >> 1;
    crc_table[i] = c;
  }
  __syncthreads();
  const int wi = threadIdx.x / 32, lane = threadIdx.x % 32;
  const i64 m = static_cast<i64>(blockIdx.x) * WARPS + wi;
  if (m >= n) return;
  const i64* row = table + 4 * m;
  const int st = inflate_member(warps[wi], crc_table, comp + row[0],
                                static_cast<int>(row[1]), out + row[2],
                                static_cast<int>(row[3]), lane);
  if (lane == 0) {
    status[m] = st;
    if (st) atomicMax(status + n, st);
  }
}

// the kernel's launches in this process, by either entry, each counted as
// it is made (duet_bgzf_launches)
std::atomic<i64> g_launches{0};

cudaError_t launch(const uint8_t* comp, const i64* table, i64 n,
                   uint8_t* out, int32_t* status, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  void* args[] = {&comp, &table, &n, &out, &status};
  const unsigned grid = static_cast<unsigned>((n + WARPS - 1) / WARPS);
  cudaError_t rc = cudaLaunchKernel(
      reinterpret_cast<const void*>(bgzf_inflate_kernel), dim3(grid),
      dim3(THREADS), args, 0, stream);
  if (rc == cudaSuccess) rc = cudaGetLastError();
  if (rc == cudaSuccess) g_launches.fetch_add(1);
  return rc;
}

double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Write a byte of each 4 KB page of p[0, bytes) on up to `threads`
// threads: the pages of the reader's window are fresh, and a copy from the
// card into them would otherwise take every first touch on one thread.
void prefault(uint8_t* p, i64 bytes, int threads) {
  const i64 page = 4096, piece = 1 << 20;
  volatile uint8_t* v = p;
  auto touch = [=](i64 lo, i64 hi) {
    for (i64 o = lo; o < hi; o += page) v[o] = 0;
  };
  const int t = static_cast<int>(
      std::max<i64>(1, std::min<i64>(threads, bytes / piece)));
  const i64 step = (bytes / t + page - 1) / page * page;
  std::vector<std::thread> pool;
  for (int k = 1; k < t; ++k)
    pool.emplace_back(touch, k * step, std::min(bytes, (k + 1) * step));
  touch(0, std::min(bytes, step));
  for (auto& th : pool) th.join();
}

// The reader's inflater on one card: the caller's device buffers (its
// batch capacity) and stream.  The copies are plain cudaMemcpyAsync from
// and to the reader's pageable windows, through the driver's own pinned
// staging: a pinned ring of our own cost more to allocate and free with
// each reader than it saved, and kept for the process it would hold its
// pages through every later stage.
struct Ctx {
  int device;
  cudaStream_t stream;
  uint8_t* d_comp;
  i64 cap_in;
  uint8_t* d_out;
  i64 cap_out;
  i64* d_table;
  int32_t* d_status;
  i64 cap_members;
  int threads;
  // the batch in the making: its compressed bytes and members so far
  i64 in_used = 0, rows = 0;
  std::vector<i64> table_buf;
  // what it did: launches, members, bytes each way, seconds
  i64 launches = 0, members = 0, h2d_bytes = 0, d2h_bytes = 0;
  double h2d_s = 0, compute_s = 0, d2h_s = 0;
  std::string error;

  int fail(cudaError_t rc, const char* what) {
    error = std::string(what) + ": " + cudaGetErrorString(rc);
    in_used = rows = 0;
    return 2;
  }

  // Copy `count` members of `comp` (rows with in_off from comp) behind the
  // batch's bytes so far.  From pageable memory each copy returns once its
  // bytes are staged, so `comp` may move when this returns.
  int add(const uint8_t* comp, const i64* table, i64 count) {
    const double t0 = now_s();
    const i64 bytes = count ? table[4 * (count - 1)] +
                              table[4 * (count - 1) + 1] : 0;
    if (rows + count > cap_members || in_used + bytes > cap_in) {
      error = "batch larger than the inflater's buffers";
      return 2;
    }
    table_buf.assign(table, table + 4 * count);
    for (i64 i = 0; i < count; ++i) table_buf[4 * i] += in_used;
    cudaError_t rc = cudaSetDevice(device);
    if (rc == cudaSuccess)
      rc = cudaMemcpyAsync(d_table + 4 * rows, table_buf.data(), count * 32,
                           cudaMemcpyHostToDevice, stream);
    if (rc == cudaSuccess)
      rc = cudaMemcpyAsync(d_comp + in_used, comp, bytes,
                           cudaMemcpyHostToDevice, stream);
    if (rc != cudaSuccess) return fail(rc, "copy to the card");
    in_used += bytes;
    rows += count;
    h2d_bytes += bytes + count * 32;
    h2d_s += now_s() - t0;
    return 0;
  }

  // Decode the batch: one launch, then its out_bytes into `out`.
  int run(uint8_t* out, i64 out_bytes) {
    const double t0 = now_s();
    const i64 n = rows;
    in_used = rows = 0;
    if (out_bytes > cap_out) {
      error = "batch larger than the inflater's buffers";
      return 2;
    }
    cudaError_t rc = cudaSetDevice(device);
    if (rc == cudaSuccess) rc = cudaMemsetAsync(d_status + n, 0, 4, stream);
    if (rc != cudaSuccess) return fail(rc, "cudaMemsetAsync");
    rc = launch(d_comp, d_table, n, d_out, d_status, stream);
    if (rc != cudaSuccess) return fail(rc, "bgzf_inflate launch");
    launches += 1;
    members += n;
    prefault(out, out_bytes, threads);   // while the kernel runs
    int32_t status = 0;
    rc = cudaMemcpyAsync(&status, d_status + n, 4, cudaMemcpyDeviceToHost,
                         stream);
    if (rc == cudaSuccess) rc = cudaStreamSynchronize(stream);
    if (rc != cudaSuccess) return fail(rc, "bgzf_inflate");
    const double t1 = now_s();
    compute_s += t1 - t0;
    if (status != 0) return 1;
    rc = cudaMemcpyAsync(out, d_out, out_bytes, cudaMemcpyDeviceToHost,
                         stream);
    if (rc == cudaSuccess) rc = cudaStreamSynchronize(stream);
    if (rc != cudaSuccess) return fail(rc, "copy from the card");
    d2h_bytes += out_bytes;
    d2h_s += now_s() - t1;
    return 0;
  }

  ~Ctx() {
    if (cudaSetDevice(device) == cudaSuccess) cudaStreamSynchronize(stream);
  }
};

}  // namespace

extern "C" {

// The kernel alone on `stream`: n members of `comp` (table rows in_off,
// in_size, out_off, out_size) into `out`, statuses into status[0..n] (the
// caller zeroes status[n]).
int duet_bgzf_launch(const uint8_t* comp, const i64* table, i64 n,
                     uint8_t* out, int32_t* status, void* stream) {
  return static_cast<int>(launch(comp, table, n, out, status,
                                 static_cast<cudaStream_t>(stream)));
}

// The kernel's launches in this process so far.
i64 duet_bgzf_launches() { return g_launches.load(); }

const char* duet_bgzf_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// An inflater context on `device` and `stream` over the caller's device
// buffers: the compressed batch (cap_in bytes, padded by 8), the inflated
// batch (cap_out), the member table (cap_members rows) and the statuses
// (cap_members + 1); `threads` host threads fault in the output's pages.
void* duet_bgzf_ctx_create(int device, void* stream, uint8_t* d_comp,
                           i64 cap_in, uint8_t* d_out, i64 cap_out,
                           i64* d_table, int32_t* d_status, i64 cap_members,
                           int threads) {
  auto* c = new Ctx();
  c->device = device;
  c->stream = static_cast<cudaStream_t>(stream);
  c->d_comp = d_comp;
  c->cap_in = cap_in;
  c->d_out = d_out;
  c->cap_out = cap_out;
  c->d_table = d_table;
  c->d_status = d_status;
  c->cap_members = cap_members;
  c->threads = threads < 1 ? 1 : threads;
  return c;
}

// The reader's inflater (duet_bam_set_inflater).  op 0 adds the table's
// n members of `comp` to the batch on the card (rows: in_off from comp,
// in_size, out_off from the batch's output, out_size); the call returns
// once `comp` is no longer needed.  op 1 decodes the batch and writes its
// out_bytes inflated bytes to `out`.  Returns 0; 1 when a member failed
// its decode or its checks; 2 on a device error (duet_bgzf_error).
int duet_bgzf_inflate(void* ctx, int op, const uint8_t* comp,
                      const i64* table, i64 n, uint8_t* out, i64 out_bytes) {
  auto* c = static_cast<Ctx*>(ctx);
  return op == 0 ? c->add(comp, table, n) : c->run(out, out_bytes);
}

const char* duet_bgzf_error(void* ctx) {
  auto* c = static_cast<Ctx*>(ctx);
  return c->error.empty() ? nullptr : c->error.c_str();
}

// out7: launches, members, h2d_bytes, d2h_bytes, h2d_s, compute_s
// (through the kernel's end, the prefault inside), d2h_s
void duet_bgzf_stats(void* ctx, double* out7) {
  auto* c = static_cast<Ctx*>(ctx);
  out7[0] = static_cast<double>(c->launches);
  out7[1] = static_cast<double>(c->members);
  out7[2] = static_cast<double>(c->h2d_bytes);
  out7[3] = static_cast<double>(c->d2h_bytes);
  out7[4] = c->h2d_s;
  out7[5] = c->compute_s;
  out7[6] = c->d2h_s;
}

void duet_bgzf_ctx_destroy(void* ctx) { delete static_cast<Ctx*>(ctx); }

}  // extern "C"
