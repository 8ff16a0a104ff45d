# A frozen copy of duet_tpu_torch/io/bgzf.py for the benchmark's plain
# reference: imports point into h100_bench.reference; the native and
# device routes, and what the reference never calls, are taken out.
"""BGZF (blocked gzip) codec.

BGZF is the container format of BAM and of tabix-indexed VCFs: a series of
gzip members, each carrying a 'BC' extra subfield with the compressed block
size, each holding <= 64 KiB of uncompressed payload, terminated by a fixed
28-byte empty block. Implemented from the SAM/BAM specification; replaces the
reference's reliance on samtools/bcftools/tabix binaries for reading
``pileup.vcf.gz`` and BAM files (reference: src/duet/snp_phasing.py:17,
sv_phasing_fn.py:25).
"""

from __future__ import annotations

import io
import struct
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
_MAX_BLOCK = 0xFF00  # uncompressed payload per block (spec recommendation)


def is_bgzf(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(18)
    if len(head) < 18 or head[:2] != b"\x1f\x8b" or head[3] & 4 == 0:
        return False
    # xlen then extra subfields; look for 'BC' subfield
    xlen = struct.unpack("<H", head[10:12])[0]
    with open(path, "rb") as f:
        f.seek(12)
        extra = f.read(xlen)
    i = 0
    while i + 4 <= len(extra):
        si1, si2, slen = extra[i], extra[i + 1], struct.unpack("<H", extra[i + 2 : i + 4])[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            return True
        i += 4 + slen
    return False


class BgzfWriter:
    """Streaming BGZF compressor.

    Every block but the last holds exactly ``_MAX_BLOCK`` payload bytes and
    is a raw-deflate stream of its own, so blocks compress in any order:
    with ``threads > 1`` each full block is deflated on a thread pool (zlib
    releases the interpreter lock) as soon as it fills, at most
    ``4 * threads`` blocks in flight, and written in order: the same bytes
    as one thread writes.  The writer keeps each block's uncompressed start
    and compressed offset, from which ``voffsets`` gives the virtual
    offsets an index needs."""

    def __init__(self, path_or_file, compresslevel: int = 6,
                 threads: int = 1):
        if isinstance(path_or_file, (str, bytes)):
            self._fh = open(path_or_file, "wb")
            self._owns = True
        else:
            self._fh = path_or_file
            self._owns = False
        self._buf = bytearray()
        self._level = compresslevel
        self._closed = False
        self._pool = ThreadPoolExecutor(threads) if threads > 1 else None
        self._depth = 4 * threads
        self._in_flight: deque = deque()  # (payload size, future block)
        self._block_u: list[int] = []     # uncompressed start of each block
        self._block_c: list[int] = []     # compressed offset of each block
        self._u = 0                       # payload bytes in written blocks
        self._c = 0                       # compressed bytes written

    def write(self, data: bytes) -> int:
        self._buf += data
        while len(self._buf) >= _MAX_BLOCK:
            self._queue(bytes(memoryview(self._buf)[:_MAX_BLOCK]))
            del self._buf[:_MAX_BLOCK]
        return len(data)

    def _block(self, payload: bytes) -> bytes:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(payload) + co.flush()
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        bsize = len(cdata) + 25 + 1  # header(12)+extra(6)+cdata+crc(4)+isize(4) == len+26
        return (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6)                     # XLEN
            + b"BC" + struct.pack("<H", 2)             # subfield id + len
            + struct.pack("<H", bsize - 1)             # BSIZE-1
            + cdata
            + struct.pack("<II", crc, len(payload) & 0xFFFFFFFF)
        )

    def _queue(self, payload: bytes) -> None:
        if self._pool is None:
            self._emit(len(payload), self._block(payload))
            return
        self._in_flight.append((len(payload),
                                self._pool.submit(self._block, payload)))
        while len(self._in_flight) > self._depth:
            self._emit_oldest()

    def _emit_oldest(self) -> None:
        size, block = self._in_flight.popleft()
        self._emit(size, block.result())

    def _emit(self, size: int, block: bytes) -> None:
        self._fh.write(block)
        self._block_u.append(self._u)
        self._block_c.append(self._c)
        self._u += size
        self._c += len(block)

    def flush(self) -> None:
        if self._buf:
            self._queue(bytes(self._buf))
            self._buf.clear()
        while self._in_flight:
            self._emit_oldest()

    def voffsets(self, uoffsets) -> np.ndarray:
        """Virtual offsets (coffset << 16 | offset in its block) of
        uncompressed offsets counted from the writer's first byte.  Each
        must lie in a block already written (all of them after close); one
        on a block boundary is the next block's, at offset 0."""
        u = np.asarray(uoffsets, dtype=np.int64)
        if u.size and (u.min() < 0 or u.max() >= self._u):
            raise ValueError("offset outside the blocks written so far")
        starts = np.asarray(self._block_u, dtype=np.int64)
        k = np.searchsorted(starts, u, side="right") - 1
        return (np.asarray(self._block_c, dtype=np.int64)[k] << 16) \
            | (u - starts[k])

    def close(self) -> None:
        if self._closed:
            return
        try:
            self.flush()
            self._fh.write(BGZF_EOF)
            self._fh.flush()
        finally:
            if self._pool is not None:
                self._pool.shutdown()
            if self._owns:
                self._fh.close()
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BgzfReader(io.RawIOBase):
    """Streaming BGZF decompressor exposing a file-like read() interface."""

    def __init__(self, path_or_file, owns: bool | None = None):
        """owns: close the underlying handle on close(); defaults to True
        for paths and False for caller-provided handles — pass True when
        handing over a handle you opened just for this reader."""
        if isinstance(path_or_file, (str, bytes)):
            self._fh = open(path_or_file, "rb")
            self._owns = True if owns is None else owns
        else:
            self._fh = path_or_file
            self._owns = False if owns is None else owns
        self._block = b""
        self._pos = 0
        self._eof = False

    def _load_block(self) -> bool:
        header = self._fh.read(12)
        if len(header) < 12:
            self._eof = True
            return False
        if header[:2] != b"\x1f\x8b":
            raise ValueError("not a BGZF stream: bad gzip magic")
        xlen = struct.unpack("<H", header[10:12])[0]
        extra = self._fh.read(xlen)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack("<H", extra[i + 2 : i + 4])[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack("<H", extra[i + 4 : i + 6])[0] + 1
            i += 4 + slen
        if bsize is None:
            raise ValueError("not a BGZF stream: missing BC subfield")
        cdata_len = bsize - 12 - xlen - 8
        cdata = self._fh.read(cdata_len)
        crc_isize = self._fh.read(8)
        if len(cdata) < cdata_len or len(crc_isize) < 8:
            raise ValueError("truncated BGZF block")
        crc, isize = struct.unpack("<II", crc_isize)
        payload = zlib.decompress(cdata, -15) if cdata_len > 0 else b""
        if len(payload) != isize:
            raise ValueError("BGZF block length mismatch")
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise ValueError("BGZF block CRC mismatch")
        self._block = payload
        self._pos = 0
        if isize == 0:
            # could be the EOF marker or an empty block; keep reading lazily
            return self._load_block()
        return True

    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        while n < 0 or len(out) < n:
            if self._pos >= len(self._block):
                if self._eof or not self._load_block():
                    break
            take = len(self._block) - self._pos if n < 0 else min(
                n - len(out), len(self._block) - self._pos
            )
            out += self._block[self._pos : self._pos + take]
            self._pos += take
        return bytes(out)

    def readable(self) -> bool:
        return True

    def close(self) -> None:
        if self._owns:
            self._fh.close()
        super().close()

