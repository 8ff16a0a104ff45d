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


class BamWriter:
    def __init__(self, path: str, header: BamHeader, compresslevel: int = 6):
        self._w = BgzfWriter(path, compresslevel)
        self.header = header
        text = header.text.encode()
        out = bytearray(b"BAM\x01")
        out += struct.pack("<i", len(text)) + text
        out += struct.pack("<i", len(header.ref_names))
        for name, length in zip(header.ref_names, header.ref_lengths):
            nb = name.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        self._w.write(bytes(out))

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


def write_bam_index(bam_path: str) -> None:
    """Write a real .bai for the BAM (duet_tpu.io.bai): the reference CLI
    contract needs the file to exist (utils.py:46-48), and IGV/pysam
    consumers of the haplotagged BAMs dereference it for random access."""
    from duet_tpu_torch.io.bai import write_bai

    write_bai(bam_path)


# back-compat name from when this wrote an empty spec-valid stub
write_bai_stub = write_bam_index
