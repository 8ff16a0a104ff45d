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

from duet_tpu_torch.io.bgzf import BgzfWriter
from duet_tpu_torch.utils.spans import span

TBI_MAGIC = b"TBI\x01"
_VCF_FORMAT = 2
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


def reg2bins(beg: int, end: int) -> list[int]:
    """All bins overlapping [beg, end) — the query-side counterpart.  As
    htslib does, beg is clamped to 0 and end to 2^29, the end of the
    binned space, so an open region (end 2^60) stays a bounded list."""
    out = [0]
    beg = max(beg, 0)
    end = min(end, 1 << 29) - 1
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return out


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


def _iter_lines_with_voffsets(path: str):
    """Yield (virtual_offset_of_line_start, line_bytes) over a BGZF text
    file; a line's voffset is where its FIRST byte lives."""
    pending = b""
    pending_vo = 0
    for coffset, payload in _iter_bgzf_blocks(path):
        start = 0
        while True:
            nl = payload.find(b"\n", start)
            if nl < 0:
                break
            if pending:
                yield pending_vo, pending + payload[start:nl]
                pending = b""
            else:
                yield (coffset << 16) | start, payload[start:nl]
            start = nl + 1
        if start < len(payload):
            if not pending:
                pending_vo = (coffset << 16) | start
            pending += payload[start:]
    if pending:
        yield pending_vo, pending


def _vcf_interval(cols: list[bytes]) -> tuple[int, int]:
    """0-based half-open [beg, end) of a VCF record (tabix VCF semantics:
    pos-1 + len(REF), or INFO END= when present)."""
    beg = int(cols[1]) - 1
    end = beg + max(len(cols[3]), 1)
    if len(cols) > 7:
        for part in cols[7].split(b";"):
            if part.startswith(b"END="):
                try:
                    end = max(end, int(part[4:]))
                except ValueError:
                    pass
                break
    return beg, end


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


def build_tabix_index(vcf_gz_path: str) -> bytes:
    """Uncompressed .tbi payload for a coordinate-sorted BGZF VCF."""
    names: list[bytes] = []
    name_id: dict[bytes, int] = {}

    records = []  # (ref_id, beg, end, vbeg) — vend filled from the next line
    eof_vo = 0
    for vo, line in _iter_lines_with_voffsets(vcf_gz_path):
        if records:
            records[-1].append(vo)  # previous record ends where this starts
        # upper bound for the FINAL record's chunk end: chunk ends are only
        # compared against, never seeked to, so overshooting is harmless
        eof_vo = vo + len(line) + 1
        if line.startswith(b"#"):
            records.append([None])  # placeholder so vend chains stay aligned
            continue
        cols = line.split(b"\t")
        chrom = cols[0]
        rid = name_id.get(chrom)
        if rid is None:
            rid = name_id[chrom] = len(names)
            names.append(chrom)
        beg, end = _vcf_interval(cols)
        records.append([(rid, beg, end, vo)])
    if records and len(records[-1]) == 1:
        records[-1].append(eof_vo)

    bins, linear = binned_index(
        (rec[0] + (rec[1],) for rec in records if rec[0] is not None),
        len(names),
    )

    concat = b"\x00".join(names) + b"\x00" if names else b""
    out = bytearray()
    out += TBI_MAGIC
    out += struct.pack("<iiiiiii", len(names), _VCF_FORMAT, 1, 2, 0,
                       ord("#"), 0)
    out += struct.pack("<i", len(concat)) + concat
    for rid in range(len(names)):
        out += struct.pack("<i", len(bins[rid]))
        for b in sorted(bins[rid]):
            chunks = bins[rid][b]
            out += struct.pack("<Ii", b, len(chunks))
            for vbeg, vend in chunks:
                out += struct.pack("<QQ", vbeg, vend)
        out += struct.pack("<i", len(linear[rid]))
        for v in linear[rid]:
            out += struct.pack("<Q", v)
    return bytes(out)


@span("index.tabix")
def write_tabix_index(vcf_gz_path: str, tbi_path: str | None = None) -> str:
    tbi_path = tbi_path or vcf_gz_path + ".tbi"
    payload = build_tabix_index(vcf_gz_path)
    with BgzfWriter(tbi_path) as w:
        w.write(payload)
    return tbi_path


# -----------------------------------------------------------------------------
# Reading / querying
# -----------------------------------------------------------------------------


def read_tabix_index(tbi_path: str):
    """Parse a .tbi into (names, bins_per_ref, linear_per_ref)."""
    from duet_tpu_torch.io.bgzf import bgzf_decompress_file

    data = bgzf_decompress_file(tbi_path)
    if data[:4] != TBI_MAGIC:
        raise ValueError("not a TBI index")
    n_ref = struct.unpack_from("<i", data, 4)[0]
    l_nm = struct.unpack_from("<i", data, 32)[0]
    names = data[36:36 + l_nm].split(b"\x00")[:-1]
    off = 36 + l_nm
    bins, linear = [], []
    for _ in range(n_ref):
        n_bin = struct.unpack_from("<i", data, off)[0]
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
        n_intv = struct.unpack_from("<i", data, off)[0]
        off += 4
        lin = list(struct.unpack_from(f"<{n_intv}Q", data, off))
        off += 8 * n_intv
        bins.append(bd)
        linear.append(lin)
    return [n.decode() for n in names], bins, linear


def _read_from_voffset(path: str, voffset: int):
    """Yield lines starting at a virtual offset (true random access)."""
    import io as _io

    from duet_tpu_torch.io.bgzf import BgzfReader

    fh = open(path, "rb")
    fh.seek(voffset >> 16)
    r = BgzfReader(fh, owns=True)  # closing the wrapper closes the handle
    r.read(voffset & 0xFFFF)  # skip into the block
    return _io.TextIOWrapper(r)


def query(vcf_gz_path: str, chrom: str, beg: int, end: int,
          tbi_path: str | None = None) -> list[str]:
    """Records of [beg, end) (0-based half-open) via the index: pick the
    minimal chunk set from the overlapping bins, seek, scan, stop early."""
    names, bins, linear = read_tabix_index(tbi_path or vcf_gz_path + ".tbi")
    if chrom not in names:
        return []
    rid = names.index(chrom)
    lin = linear[rid]
    min_vo = lin[min(beg >> _LINEAR_SHIFT, len(lin) - 1)] if lin else 0
    chunks = []
    for b in reg2bins(beg, end):
        for vbeg, vend in bins[rid].get(b, []):
            if vend > min_vo:
                chunks.append((max(vbeg, min_vo), vend))
    if not chunks:
        return []
    chunks.sort()
    out = []
    start = chunks[0][0]
    seen_chrom = False
    f = _read_from_voffset(vcf_gz_path, start)
    for line in f:
        if line.startswith("#"):
            continue
        cols = line.rstrip("\n").split("\t")
        if cols[0] != chrom:
            if seen_chrom:
                break  # records are grouped per contig: past the target
            continue
        seen_chrom = True
        r_beg, r_end = _vcf_interval([c.encode() for c in cols])
        if r_beg >= end:
            break
        if r_end > beg:
            out.append(line.rstrip("\n"))
    f.close()
    return out
