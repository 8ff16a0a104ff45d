# A frozen copy of duet_tpu_torch/io/tabix.py for the benchmark's plain
# reference: imports point into h100_bench.reference; the native and
# device routes, and what the reference never calls, are taken out.
"""Tabix (.tbi) index codec: build, write, and query region indexes for
BGZF-compressed, coordinate-sorted VCFs.

The reference pipeline tabix-indexes every per-contig phased VCF
(`tabix -f -p vcf`, reference src/duet/snp_phasing.py:25) so WhatsHap and
downstream consumers can random-access regions.  This module provides the
same artifact without the external binary, implemented from the tabix/SAM
spec: the UCSC hierarchical binning scheme over virtual file offsets
(coffset << 16 | uoffset into the uncompressed block), a 16 kb linear
index, and a BGZF-compressed TBI\\1 payload.  `query()` performs true
random access through the index — seek to a block, not a scan — which is
also how the tests prove index correctness.
"""

from __future__ import annotations

import struct
import zlib


_LINEAR_SHIFT = 14  # 16 kb windows


def reg2bin(beg: int, end: int) -> int:
    """UCSC bin for the 0-based half-open interval [beg, end)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _iter_bgzf_blocks(path: str):
    """Yield (compressed_file_offset, payload) per BGZF block."""
    with open(path, "rb") as fh:
        while True:
            coffset = fh.tell()
            header = fh.read(12)
            if len(header) < 12:
                return
            xlen = struct.unpack("<H", header[10:12])[0]
            extra = fh.read(xlen)
            bsize = None
            i = 0
            while i + 4 <= len(extra):
                si1, si2, slen = extra[i], extra[i + 1], \
                    struct.unpack("<H", extra[i + 2:i + 4])[0]
                if si1 == 0x42 and si2 == 0x43 and slen == 2:
                    bsize = struct.unpack("<H", extra[i + 4:i + 6])[0] + 1
                i += 4 + slen
            if bsize is None:
                raise ValueError("not a BGZF stream: missing BC subfield")
            cdata = fh.read(bsize - 12 - xlen - 8)
            fh.read(8)  # crc + isize
            payload = zlib.decompress(cdata, -15) if cdata else b""
            if payload:
                yield coffset, payload


def binned_index(records, n_ref: int):
    """Shared TBI/BAI accumulation: records of (ref_id, beg, end, vbeg, vend)
    in file order -> per-ref ({bin: [[vbeg, vend], ...]}, linear ioffs)."""
    bins: list[dict[int, list]] = [{} for _ in range(n_ref)]
    linear: list[list[int]] = [[] for _ in range(n_ref)]
    for rid, beg, end, vbeg, vend in records:
        b = reg2bin(beg, end)
        chunks = bins[rid].setdefault(b, [])
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1][1] = vend  # merge contiguous records of one bin
        else:
            chunks.append([vbeg, vend])
        lin = linear[rid]
        lo, hi = beg >> _LINEAR_SHIFT, max(end - 1, beg) >> _LINEAR_SHIFT
        if len(lin) <= hi:
            lin.extend([0] * (hi + 1 - len(lin)))
        for w in range(lo, hi + 1):
            if lin[w] == 0 or vbeg < lin[w]:
                lin[w] = vbeg
    # forward-fill empty linear windows (htslib convention)
    for lin in linear:
        last = 0
        for i, v in enumerate(lin):
            if v == 0:
                lin[i] = last
            else:
                last = v
    return bins, linear


# -----------------------------------------------------------------------------
# Reading / querying
# -----------------------------------------------------------------------------

