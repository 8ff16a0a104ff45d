# A frozen copy of duet_tpu_torch/io/bai.py for the benchmark's plain
# reference: imports point into h100_bench.reference; the native and
# device routes, and what the reference never calls, are taken out.
"""BAI index codec: real .bai indexes for coordinate-sorted BAMs, plus an
index-backed region query.

Replaces the spec-valid-but-empty stub the framework wrote before: the
reference contract only checks that `.bai` exists (utils.py:46-48), but
downstream consumers (IGV, pysam/samtools users of the haplotagged BAMs)
dereference the index for random access.  BAI is the same UCSC binning +
16 kb linear-index scheme as tabix over BAM virtual offsets; the payload is
raw (not BGZF-wrapped, unlike .tbi) and carries an optional trailing count
of unplaced reads.
"""

from __future__ import annotations

import struct

import numpy as np

from h100_bench.reference.tabix import _iter_bgzf_blocks, binned_index

BAI_MAGIC = b"BAI\x01"
_REF_CONSUMING = frozenset((0, 2, 3, 7, 8))  # M D N = X


class _VCursor:
    """Sequential reader over BGZF blocks that reports the virtual offset
    (coffset << 16 | uoffset) of the NEXT byte to be read."""

    def __init__(self, path: str):
        self._blocks = _iter_bgzf_blocks(path)
        self._co = 0
        self._buf = b""
        self._uo = 0
        self._done = False

    def _ensure(self) -> bool:
        while self._uo >= len(self._buf):
            nxt = next(self._blocks, None)
            if nxt is None:
                self._done = True
                return False
            self._co, self._buf = nxt
            self._uo = 0
        return True

    def voffset(self) -> int:
        self._ensure()
        return (self._co << 16) | self._uo

    def read(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n and self._ensure():
            take = min(n - len(out), len(self._buf) - self._uo)
            out += self._buf[self._uo:self._uo + take]
            self._uo += take
        return bytes(out)


def _record_span(body: bytes) -> tuple[int, int, int]:
    """(ref_id, pos, end) from a raw BAM record body; end = pos+1 when the
    record is unmapped or has no reference-consuming CIGAR op."""
    ref_id, pos, l_read_name = struct.unpack_from("<iiB", body, 0)
    (n_cigar,) = struct.unpack_from("<H", body, 12)
    off = 32 + l_read_name
    span = 0
    cig = np.frombuffer(body, dtype="<u4", count=n_cigar, offset=off)
    for c in cig:
        if int(c) & 0xF in _REF_CONSUMING:
            span += int(c) >> 4
    return ref_id, pos, pos + max(span, 1)


def build_bai(bam_path: str) -> bytes:
    """Raw .bai payload for a coordinate-sorted BAM."""
    cur = _VCursor(bam_path)
    if cur.read(4) != b"BAM\x01":
        raise ValueError(f"{bam_path}: not a BAM file")
    (l_text,) = struct.unpack("<i", cur.read(4))
    cur.read(l_text)
    (n_ref,) = struct.unpack("<i", cur.read(4))
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", cur.read(4))
        cur.read(l_name + 4)

    records = []
    prev = None  # (rid, beg, end, vbeg)
    n_no_coor = 0
    while True:
        if not cur._ensure():
            break
        vo = cur.voffset()
        raw = cur.read(4)
        if len(raw) < 4:
            break
        (block_size,) = struct.unpack("<i", raw)
        body = cur.read(block_size)
        if prev is not None:
            records.append(prev + (vo,))
            prev = None
        rid, pos, end = _record_span(body)
        if rid < 0 or pos < 0:
            n_no_coor += 1
            continue
        prev = (rid, pos, end, vo)
    if prev is not None:
        # chunk ends are upper bounds only; past-the-end is harmless
        records.append(prev + (((prev[3] >> 16) + 1) << 16,))

    bins, linear = binned_index(iter(records), n_ref)
    return _bai_payload(bins, linear, n_ref, n_no_coor)


def _bai_payload(bins, linear, n_ref: int, n_no_coor: int) -> bytes:
    out = bytearray(BAI_MAGIC)
    out += struct.pack("<i", n_ref)
    for rid in range(n_ref):
        out += struct.pack("<i", len(bins[rid]))
        for b in sorted(bins[rid]):
            chunks = bins[rid][b]
            out += struct.pack("<Ii", b, len(chunks))
            for vbeg, vend in chunks:
                out += struct.pack("<QQ", vbeg, vend)
        out += struct.pack("<i", len(linear[rid]))
        for v in linear[rid]:
            out += struct.pack("<Q", v)
    out += struct.pack("<Q", n_no_coor)
    return bytes(out)


def write_bai(bam_path: str, bai_path: str | None = None) -> str:
    bai_path = bai_path or bam_path + ".bai"
    with open(bai_path, "wb") as f:
        f.write(build_bai(bam_path))
    return bai_path

