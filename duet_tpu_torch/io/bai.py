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

from duet_tpu_torch.io.tabix import _iter_bgzf_blocks, binned_index, reg2bins

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


def bai_from_offsets(n_ref: int, ref_id, pos, end, vbeg) -> bytes:
    """Raw .bai payload from what a writer knows of the records it wrote,
    in file order: reference id, position, end (pos + max(reference span,
    1)) and virtual start offset, with no re-read.  The bytes are
    build_bai's: a chunk ends where the next record starts, the last
    record's at the start of the block after its own, and a record with
    no coordinate (reference id or position below 0) is counted, not
    binned."""
    ref_id, pos, end, vbeg = (np.asarray(a, np.int64)
                              for a in (ref_id, pos, end, vbeg))
    vend = np.empty_like(vbeg)
    vend[:-1] = vbeg[1:]
    if len(vbeg):
        vend[-1] = ((vbeg[-1] >> 16) + 1) << 16
    placed = (ref_id >= 0) & (pos >= 0)
    records = zip(*(a[placed].tolist() for a in (ref_id, pos, end, vbeg,
                                                  vend)))
    bins, linear = binned_index(records, n_ref)
    return _bai_payload(bins, linear, n_ref, int((~placed).sum()))


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


def read_bai(bai_path: str):
    """Parse a .bai into (bins_per_ref, linear_per_ref, n_no_coor)."""
    with open(bai_path, "rb") as f:
        data = f.read()
    if data[:4] != BAI_MAGIC:
        raise ValueError("not a BAI index")
    (n_ref,) = struct.unpack_from("<i", data, 4)
    off = 8
    bins, linear = [], []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bd = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                vbeg, vend = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((vbeg, vend))
            bd[b] = chunks
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        lin = list(struct.unpack_from(f"<{n_intv}Q", data, off))
        off += 8 * n_intv
        bins.append(bd)
        linear.append(lin)
    n_no_coor = struct.unpack_from("<Q", data, off)[0] if off + 8 <= len(data) else 0
    return bins, linear, n_no_coor


def bam_query(bam_path: str, contig: str, beg: int, end: int,
              bai_path: str | None = None):
    """Alignments overlapping [beg, end) via the index: seek to the minimal
    chunk start, scan, stop at the first record past the window."""
    from duet_tpu_torch.io.bam import BamReader
    from duet_tpu_torch.io.bgzf import BgzfReader

    with BamReader(bam_path) as r:
        names = r.header.ref_names
    if contig not in names:
        return []
    rid = names.index(contig)
    bins, linear, _ = read_bai(bai_path or bam_path + ".bai")
    lin = linear[rid]
    min_vo = lin[min(beg >> 14, len(lin) - 1)] if lin else 0
    chunks = [(max(vbeg, min_vo), vend)
              for b in reg2bins(beg, end)
              for vbeg, vend in bins[rid].get(b, [])
              if vend > min_vo]
    if not chunks:
        return []
    start = min(c[0] for c in chunks)
    fh = open(bam_path, "rb")
    fh.seek(start >> 16)
    rr = BgzfReader(fh, owns=True)  # lazy: decoding starts at sought block
    rr.read(start & 0xFFFF)
    out = []
    while True:
        raw = rr.read(4)
        if len(raw) < 4:
            break
        (block_size,) = struct.unpack("<i", raw)
        body = rr.read(block_size)
        r_rid, r_pos, r_end = _record_span(body)
        # coordinate-sorted: stop once the scan is past the target contig
        # or window (unmapped rid<0 records trail every mapped one)
        if r_rid > rid or r_rid < 0 or (r_rid == rid and r_pos >= end):
            break
        if r_rid == rid and r_end > beg:
            out.append(BamReader._parse_record(body))
    rr.close()
    return out
