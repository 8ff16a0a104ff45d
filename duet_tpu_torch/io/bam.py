"""BAM binary codec (reader + writer), implemented from the SAM/BAM spec.

Replaces the reference's `samtools view` text round-trip
(src/duet/sv_phasing_fn.py:25-29): instead of dumping alignments to ASCII and
positionally slicing the trailing HP/PC/PS tags, records are decoded directly
from the binary stream and tags are looked up *by name* — fixing the
positional-tag fragility called out in SURVEY.md §7.3 while preserving the
keep-only-if-PC-present join semantics.

CIGAR op order: MIDNSHP=X (codes 0..8).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from duet_tpu_torch.io.bgzf import BgzfReader, BgzfWriter

CIGAR_OPS = "MIDNSHP=X"
# ops that consume query / reference
CONSUMES_QUERY = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=np.uint8)
CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.uint8)

SEQ_NIBBLE = "=ACMGRSVTWYHKDBN"
_NIB_OF_BASE = {b: i for i, b in enumerate(SEQ_NIBBLE)}
# nibble -> framework base code (A=0 C=1 G=2 T=3 N/other=4)
NIBBLE_TO_CODE = np.full(16, 4, dtype=np.uint8)
for _nib, _code in ((1, 0), (2, 1), (4, 2), (8, 3)):
    NIBBLE_TO_CODE[_nib] = _code
CODE_TO_NIBBLE = np.array([1, 2, 4, 8, 15], dtype=np.uint8)

FLAG_UNMAPPED = 0x4
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800


@dataclass
class BamHeader:
    text: str
    ref_names: list[str]
    ref_lengths: list[int]

    def ref_id(self, name: str) -> int:
        return self.ref_names.index(name)


@dataclass
class BamRead:
    name: str
    flag: int
    ref_id: int
    pos: int  # 0-based leftmost
    mapq: int
    cigar: np.ndarray  # (n,2) int32 [op, length]
    seq_codes: np.ndarray  # uint8 base codes
    quals: np.ndarray  # uint8 phred
    tags: dict = field(default_factory=dict)

    @property
    def is_mapped(self) -> bool:
        return not (self.flag & FLAG_UNMAPPED)

    @property
    def is_primary(self) -> bool:
        return not (self.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY))

    def ref_end(self) -> int:
        """0-based exclusive end on the reference."""
        if len(self.cigar) == 0:
            return self.pos + 1
        ops = self.cigar[:, 0]
        lens = self.cigar[:, 1]
        return int(self.pos + lens[CONSUMES_REF[ops] == 1].sum())

    def cigar_string(self) -> str:
        return "".join(f"{int(l)}{CIGAR_OPS[int(o)]}" for o, l in self.cigar)


def _encode_seq(codes: np.ndarray) -> bytes:
    nibs = CODE_TO_NIBBLE[np.asarray(codes, dtype=np.uint8)]
    if len(nibs) % 2:
        nibs = np.concatenate([nibs, np.zeros(1, dtype=np.uint8)])
    packed = (nibs[0::2] << 4) | nibs[1::2]
    return packed.tobytes()


def _decode_seq(data: bytes, l_seq: int) -> np.ndarray:
    raw = np.frombuffer(data, dtype=np.uint8)
    nibs = np.empty(len(raw) * 2, dtype=np.uint8)
    nibs[0::2] = raw >> 4
    nibs[1::2] = raw & 0xF
    return NIBBLE_TO_CODE[nibs[:l_seq]]


_TAG_FMT = {
    ord("c"): ("<b", 1), ord("C"): ("<B", 1),
    ord("s"): ("<h", 2), ord("S"): ("<H", 2),
    ord("i"): ("<i", 4), ord("I"): ("<I", 4),
    ord("f"): ("<f", 4), ord("A"): ("c", 1),
}


def _parse_tags(buf: bytes) -> dict:
    tags: dict = {}
    i = 0
    n = len(buf)
    while i + 3 <= n:
        key = buf[i : i + 2].decode()
        typ = buf[i + 2]
        i += 3
        if typ in _TAG_FMT:
            fmt, size = _TAG_FMT[typ]
            (val,) = struct.unpack_from(fmt, buf, i)
            if typ == ord("A"):
                val = val.decode()
            i += size
        elif typ in (ord("Z"), ord("H")):
            end = buf.index(0, i)
            val = buf[i:end].decode()
            i = end + 1
        elif typ == ord("B"):
            sub = buf[i]
            count = struct.unpack_from("<I", buf, i + 1)[0]
            fmt, size = _TAG_FMT[sub]
            val = np.frombuffer(buf, dtype=np.dtype(fmt[1:]).newbyteorder("<"),
                                count=count, offset=i + 5).copy()
            i += 5 + count * size
        else:
            raise ValueError(f"unknown BAM tag type {chr(typ)!r} for {key}")
        tags[key] = val
    return tags


def _encode_tags(tags: dict) -> bytes:
    out = bytearray()
    for key, val in tags.items():
        out += key.encode()
        if isinstance(val, bool):
            raise ValueError("bool tags unsupported")
        if isinstance(val, (int, np.integer)):
            v = int(val)
            if -(2**31) <= v < 2**31:
                out += b"i" + struct.pack("<i", v)
            else:
                raise ValueError(f"tag int out of range: {key}={v}")
        elif isinstance(val, float):
            out += b"f" + struct.pack("<f", val)
        elif isinstance(val, str):
            out += b"Z" + val.encode() + b"\x00"
        elif isinstance(val, np.ndarray):
            sub = {np.dtype(np.int32): b"i", np.dtype(np.uint8): b"C",
                   np.dtype(np.float32): b"f", np.dtype(np.int8): b"c",
                   np.dtype(np.uint32): b"I", np.dtype(np.int16): b"s",
                   np.dtype(np.uint16): b"S"}[val.dtype]
            out += b"B" + sub + struct.pack("<I", len(val)) + val.tobytes()
        else:
            raise ValueError(f"unsupported tag value type for {key}: {type(val)}")
    return bytes(out)


class BamReader:
    def __init__(self, path: str):
        from duet_tpu_torch.io.bgzf import BGZF_EOF

        # a BAM without the spec's 28-byte BGZF EOF marker is truncated —
        # without this check a file cut at a BGZF member boundary decodes
        # as a clean-looking PARTIAL dataset (silently dropping the tail).
        # Checked here (BAM-specific): external plain-gzip VCFs legally
        # lack the marker and must stay readable through BgzfReader.
        # Legacy writers that omit the (optional-per-spec) marker can be
        # accepted explicitly with DUET_TPU_ALLOW_NO_BGZF_EOF=1 — a
        # warning replaces the error (htslib's behavior).
        import os as _os

        with open(path, "rb") as fh:
            fh.seek(0, 2)
            too_short = fh.tell() < len(BGZF_EOF)
            if not too_short:
                fh.seek(-len(BGZF_EOF), 2)
                missing = fh.read(len(BGZF_EOF)) != BGZF_EOF
            else:
                missing = True
        if missing:
            if _os.environ.get("DUET_TPU_ALLOW_NO_BGZF_EOF") == "1" \
                    and not too_short:
                import logging

                logging.getLogger("duet_tpu").warning(
                    "%s: no BGZF EOF marker (legacy writer?); proceeding "
                    "per DUET_TPU_ALLOW_NO_BGZF_EOF=1 — a truncated file "
                    "would decode PARTIALLY", path)
            else:
                raise ValueError(
                    f"{path}: truncated BAM: missing BGZF EOF marker "
                    "(set DUET_TPU_ALLOW_NO_BGZF_EOF=1 to accept legacy "
                    "writers that omit it)")
        self._r = BgzfReader(path)
        magic = self._r.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", self._r.read(4))
        text = self._r.read(l_text).rstrip(b"\x00").decode()
        (n_ref,) = struct.unpack("<i", self._r.read(4))
        names, lengths = [], []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._r.read(4))
            names.append(self._r.read(l_name)[:-1].decode())
            lengths.append(struct.unpack("<i", self._r.read(4))[0])
        self.header = BamHeader(text, names, lengths)

    def __iter__(self):
        return self

    def __next__(self) -> BamRead:
        raw = self._r.read(4)
        if len(raw) < 4:
            raise StopIteration
        (block_size,) = struct.unpack("<i", raw)
        buf = self._r.read(block_size)
        return self._parse_record(buf)

    @staticmethod
    def _parse_record(buf: bytes) -> BamRead:
        (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
         _next_ref, _next_pos, _tlen) = struct.unpack_from("<iiBBHHHiiii", buf, 0)
        off = 32
        name = buf[off : off + l_read_name - 1].decode()
        off += l_read_name
        cig_raw = np.frombuffer(buf, dtype="<u4", count=n_cigar, offset=off)
        cigar = np.empty((n_cigar, 2), dtype=np.int32)
        cigar[:, 0] = cig_raw & 0xF
        cigar[:, 1] = cig_raw >> 4
        off += 4 * n_cigar
        seq_bytes = (l_seq + 1) // 2
        seq = _decode_seq(buf[off : off + seq_bytes], l_seq)
        off += seq_bytes
        quals = np.frombuffer(buf, dtype=np.uint8, count=l_seq, offset=off).copy()
        off += l_seq
        tags = _parse_tags(buf[off:])
        return BamRead(name, flag, ref_id, pos, mapq, cigar, seq, quals, tags)

    def close(self):
        self._r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _reg2bin(beg: int, end: int) -> int:
    """UCSC binning scheme from the SAM spec."""
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


def encode_header(header: BamHeader) -> bytes:
    """The BAM magic, header text and reference list that open a BAM."""
    text = header.text.encode()
    out = bytearray(b"BAM\x01")
    out += struct.pack("<i", len(text)) + text
    out += struct.pack("<i", len(header.ref_names))
    for name, length in zip(header.ref_names, header.ref_lengths):
        nb = name.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
    return bytes(out)


class BamWriter:
    def __init__(self, path: str, header: BamHeader, compresslevel: int = 6):
        self._w = BgzfWriter(path, compresslevel)
        self.header = header
        self._w.write(encode_header(header))

    def write(self, read: BamRead) -> None:
        name_b = read.name.encode() + b"\x00"
        cig = (read.cigar[:, 1].astype(np.uint32) << 4) | read.cigar[:, 0].astype(np.uint32)
        seq_b = _encode_seq(read.seq_codes)
        tag_b = _encode_tags(read.tags)
        l_seq = len(read.seq_codes)
        end = read.ref_end() if read.is_mapped else read.pos + 1
        rec = struct.pack(
            "<iiBBHHHiiii",
            read.ref_id, read.pos, len(name_b), read.mapq,
            _reg2bin(read.pos, max(end, read.pos + 1)),
            len(read.cigar), read.flag, l_seq, -1, -1, 0,
        )
        body = (
            rec + name_b + cig.astype("<u4").tobytes() + seq_b
            + read.quals.astype(np.uint8).tobytes() + tag_b
        )
        self._w.write(struct.pack("<i", len(body)) + body)

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# block_size and the 32-byte fixed part of a record; the HP, PC, PS tags
_FIXED = np.dtype([("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
                   ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                   ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
                   ("next_ref_id", "<i4"), ("next_pos", "<i4"),
                   ("tlen", "<i4")])
_HAP_TAGS = np.dtype([("hp_key", "S3"), ("hp", "<i4"), ("pc_key", "S3"),
                      ("pc", "<i4"), ("ps_key", "S3"), ("ps", "<i4")])


def _pair_table() -> np.ndarray:
    """Two base codes read as one little-endian uint16 -> their packed
    byte (_encode_seq's nibbles, the first high)."""
    first, second = np.meshgrid(np.arange(len(CODE_TO_NIBBLE)),
                                np.arange(len(CODE_TO_NIBBLE)), indexing="ij")
    table = np.zeros(1 << 16, np.uint8)
    table[first | second << 8] = CODE_TO_NIBBLE[first] << 4 \
        | CODE_TO_NIBBLE[second]
    return table


_PAIR_BYTE = _pair_table()


def _reg2bin_np(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """_reg2bin over arrays: the finest level holding [beg, end)."""
    last = end - 1
    out = np.zeros(len(beg), np.int64)
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out = np.where(beg >> shift == last >> shift, base + (beg >> shift),
                       out)
    return out


def _copy(out: memoryview, dst: np.ndarray, src: memoryview,
          start: np.ndarray, lens: np.ndarray) -> None:
    """out[dst[i]:dst[i] + lens[i]] = src[start[i]:start[i] + lens[i]]: one
    copy a read, whose cost does not grow with the read's length."""
    for d, s, k in zip(dst.tolist(), start.tolist(), lens.tolist()):
        out[d:d + k] = src[s:s + k]


def _rows(out: np.ndarray, dst: np.ndarray, rows: np.ndarray) -> None:
    """out[dst[i]:dst[i] + width] = rows[i]."""
    out[dst[:, None] + np.arange(rows.shape[1])] = rows


# bytes of records a piece of encode_records' stream: a contig's stream
# never exists whole, and a writer's pool deflates one piece while the
# next is encoded
CHUNK_BYTES = 1 << 20


def encode_records(cr, haps: dict):
    """One contig's reads (a ``readstore.ContigReads``) as the records of a
    BAM whose only reference it is, built column by column with numpy:
    byte for byte what ``BamWriter.write`` writes for each read, with flag
    0x10 on the reverse strand and 0x800 on a supplementary alignment, and
    the tags HP, PC, PS of the reads that ``haps`` (name -> (hap, ps, pc))
    holds.

    Returns (pos, end, sizes, chunks): each record's position, its end as
    an index counts it (pos + max(reference span, 1)), its size with its
    block_size field, and an iterator over the records, in order, in
    pieces of about ``CHUNK_BYTES``."""
    n = cr.n
    names = [nm.encode() for nm in cr.names]
    l_name = np.fromiter(map(len, names), np.int64, n) + 1
    name_off = np.concatenate([[0], np.cumsum(l_name)])
    name_blob = np.frombuffer(b"\x00".join(names) + b"\x00", np.uint8) \
        if n else np.zeros(0, np.uint8)
    found = [haps.get(nm) for nm in cr.names]
    tagged = np.fromiter((t is not None for t in found), bool, n)
    tag_vals = np.array([t for t in found if t is not None],
                        np.int64).reshape(-1, 3)
    tags = np.zeros(len(tag_vals), _HAP_TAGS)
    for key, col in (("hp", 0), ("ps", 1), ("pc", 2)):
        tags[key + "_key"] = key.upper().encode() + b"i"
        tags[key] = tag_vals[:, col]
    tag_row = np.cumsum(tagged) - 1

    pos = np.asarray(cr.starts, np.int64)
    cig_off = np.asarray(cr.cigar_off, np.int64)
    seq_off = np.asarray(cr.seq_off, np.int64)
    n_cig = np.diff(cig_off)
    l_seq = np.diff(seq_off)
    ref_len = np.where(CONSUMES_REF[cr.cigar_ops] == 1, cr.cigar_lens, 0)
    ref_cum = np.concatenate([[0], np.cumsum(ref_len, dtype=np.int64)])
    end = pos + np.maximum(ref_cum[cig_off[1:]] - ref_cum[cig_off[:-1]], 1)
    bins = _reg2bin_np(pos, end)
    if n and (l_name.max() > 0xFF or n_cig.max() > 0xFFFF
              or bins.max() > 0xFFFF or pos.min() < 0
              or pos.max() >= 2 ** 31):
        raise ValueError(f"{cr.contig}: a read does not fit a BAM record")
    if cr.seq.size and cr.seq.max() >= len(CODE_TO_NIBBLE):
        raise ValueError(f"{cr.contig}: a base code is not one of A C G T N")
    if tag_vals.size and (tag_vals.min() < -2 ** 31
                          or tag_vals.max() >= 2 ** 31):
        raise ValueError(f"{cr.contig}: a tag value is out of int32 range")
    flag = np.where(np.asarray(cr.strand) != 0, 0x10, 0) \
        | np.where(np.asarray(cr.supp) != 0, 0x800, 0)
    half = (l_seq + 1) // 2
    sizes = 36 + l_name + 4 * n_cig + half + l_seq + 21 * tagged
    rec_off = np.concatenate([[0], np.cumsum(sizes)])

    def encode(a: int, b: int) -> bytes:
        out = np.empty(int(rec_off[b] - rec_off[a]), np.uint8)  # all set
        view = memoryview(out)
        at = rec_off[a:b] - rec_off[a]
        fixed = np.zeros(b - a, _FIXED)
        fixed["block_size"] = sizes[a:b] - 4
        fixed["pos"] = pos[a:b]
        fixed["l_read_name"] = l_name[a:b]
        fixed["mapq"] = cr.mapq[a:b]
        fixed["bin"] = bins[a:b]
        fixed["n_cigar"] = n_cig[a:b]
        fixed["flag"] = flag[a:b]
        fixed["l_seq"] = l_seq[a:b]
        fixed["next_ref_id"] = fixed["next_pos"] = -1
        _rows(out, at, fixed.view(np.uint8).reshape(b - a, _FIXED.itemsize))
        at = at + 36
        _copy(view, at, memoryview(name_blob), name_off[a:b], l_name[a:b])
        at = at + l_name[a:b]
        c0, c1 = cig_off[a], cig_off[b]
        cig = (cr.cigar_lens[c0:c1].astype(np.uint32) << 4) \
            | cr.cigar_ops[c0:c1].astype(np.uint32)
        _copy(view, at, memoryview(cig.astype("<u4").view(np.uint8)),
              4 * (cig_off[a:b] - c0), 4 * n_cig[a:b])
        at = at + 4 * n_cig[a:b]
        # the sequence as packed pairs from an even and from an odd start,
        # so that each read's bytes are one slice of either; an odd-length
        # read's last byte then ends in a zero nibble, as _encode_seq pads
        s0, s1 = seq_off[a], seq_off[b]
        m = (s1 - s0) // 2 + 1
        codes = np.zeros(2 * m + 2, np.uint8)
        codes[:s1 - s0] = cr.seq[s0:s1]
        pairs = (_PAIR_BYTE[codes[:2 * m].view("<u2")],
                 _PAIR_BYTE[codes[1:2 * m + 1].view("<u2")])
        start = seq_off[a:b] - s0
        h = half[a:b]
        for parity, packed in enumerate(pairs):
            sel = start % 2 == parity
            _copy(view, at[sel], memoryview(packed), start[sel] // 2, h[sel])
        odd = l_seq[a:b] % 2 == 1
        out[(at + h - 1)[odd]] &= 0xF0
        at = at + h
        _copy(view, at, memoryview(cr.qual[s0:s1]), start, l_seq[a:b])
        at = at + l_seq[a:b]
        t = tagged[a:b]
        if t.any():
            _rows(out, at[t], tags[tag_row[a:b][t]].view(np.uint8).reshape(
                -1, _HAP_TAGS.itemsize))
        return out.tobytes()

    def chunks():
        a = 0
        while a < n:
            b = int(np.searchsorted(rec_off, rec_off[a] + CHUNK_BYTES,
                                    side="right")) - 1
            b = min(max(b, a + 1), n)
            yield encode(a, b)
            a = b

    return pos, end, sizes, chunks()


def write_bam_index(bam_path: str) -> None:
    """Write a real .bai for the BAM (duet_tpu.io.bai): the reference CLI
    contract needs the file to exist (utils.py:46-48), and IGV/pysam
    consumers of the haplotagged BAMs dereference it for random access."""
    from duet_tpu_torch.io.bai import write_bai

    write_bai(bam_path)


# back-compat name from when this wrote an empty spec-valid stub
write_bai_stub = write_bam_index
