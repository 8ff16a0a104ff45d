"""The BAM's BGZF members inflated on the card: ``csrc/bgzf_inflate.cu``,
its wrappers, and its plain counterpart, Python's ``zlib`` per member.

- ``inflate_members(comp, table)``: the members of a uint8 tensor
  ``comp`` whose rows of the (n, 4) int64 ``table`` are (in_off, in_size,
  out_off, out_size) inflated into one uint8 tensor, with each member's
  status (``STATUS``) and, last, the worst.  On a CUDA tensor the kernel
  ``bgzf_inflate`` runs (one launch, one warp a member) or the call
  raises; on a CPU tensor ``inflate_plain`` does the same with zlib.
- ``CardInflater``: the native reader's inflater on a card
  (``duet_bam_set_inflater``): the batch buffers on the card, the C
  context over them, and what it did.  ``io.native_ingest``
  opens one for a decode that the route rule
  (``pipeline.PipelineConfig.inflate_device``) sends to the card.
- ``member_table(buf)``: the table of a buffer of whole BGZF members.

``launches()`` counts the kernel's launches, by either entry: the library
counts each as it is made.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib

import numpy as np
import torch

# the kernel's member statuses
STATUS = {0: "ok", 1: "bad DEFLATE data", 2: "bad gzip header",
          3: "CRC32 mismatch", 4: "byte count mismatch"}
# a batch on the card: at most these compressed bytes, inflated bytes and
# members (the reader fills batches up to them)
BATCH_IN = 64 << 20
BATCH_OUT = 256 << 20
BATCH_MEMBERS = 1 << 16
_PAD = 64   # the kernel reads whole 32-bit words past a member's end

_launches_base = 0   # the library's count at the last reset_launches


class CardInflateError(RuntimeError):
    """The card route failed for a reason of the card, not of the data."""


def _library_launches() -> int:
    # no launch before the library loads, and no build just to count
    if _library.cache_info().currsize == 0:
        return 0
    return int(_library().duet_bgzf_launches())


def reset_launches() -> None:
    global _launches_base
    _launches_base = _library_launches()


def launches() -> dict:
    """{"bgzf_inflate": the kernel's launches since reset_launches}."""
    return {"bgzf_inflate": _library_launches() - _launches_base}


@functools.cache
def _library() -> ctypes.CDLL:
    from duet_tpu_torch.ops.cuda_build import load

    lib = load("bgzf_inflate", ["bgzf_inflate.cu"])
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.duet_bgzf_launch.argtypes = [ptr, ptr, i64, ptr, ptr, ptr]
    lib.duet_bgzf_launch.restype = i32
    lib.duet_bgzf_launches.argtypes = []
    lib.duet_bgzf_launches.restype = i64
    lib.duet_bgzf_error_string.argtypes = [i32]
    lib.duet_bgzf_error_string.restype = ctypes.c_char_p
    lib.duet_bgzf_ctx_create.argtypes = [i32, ptr, ptr, i64, ptr, i64, ptr,
                                         ptr, i64, i32]
    lib.duet_bgzf_ctx_create.restype = ptr
    lib.duet_bgzf_error.argtypes = [ptr]
    lib.duet_bgzf_error.restype = ctypes.c_char_p
    lib.duet_bgzf_stats.argtypes = [ptr, ctypes.POINTER(ctypes.c_double)]
    lib.duet_bgzf_stats.restype = None
    lib.duet_bgzf_ctx_destroy.argtypes = [ptr]
    lib.duet_bgzf_ctx_destroy.restype = None
    return lib


def build() -> None:
    """Build (or load) the library."""
    _library()


def member_table(buf) -> np.ndarray:
    """(n, 4) int64 rows (in_off, in_size, out_off, out_size) of the whole
    BGZF members that fill `buf` (bytes or a uint8 array), each member's
    size from its BC field and its output size from its ISIZE."""
    data = bytes(buf)
    rows = []
    off = out = 0
    while off < len(data):
        if data[off:off + 2] != b"\x1f\x8b" or off + 18 > len(data):
            raise ValueError(f"no BGZF member at byte {off}")
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        bsize = None
        x = off + 12
        while x + 4 <= off + 12 + xlen:
            slen = struct.unpack_from("<H", data, x + 2)[0]
            if data[x:x + 2] == b"BC" and slen == 2:
                bsize = struct.unpack_from("<H", data, x + 4)[0] + 1
            x += 4 + slen
        if bsize is None or off + bsize > len(data):
            raise ValueError(f"no BGZF block size at byte {off}")
        isize = struct.unpack_from("<I", data, off + bsize - 4)[0]
        rows.append((off, bsize, out, isize))
        off += bsize
        out += isize
    return np.array(rows, np.int64).reshape(-1, 4)


def _status_of(err: zlib.error) -> int:
    msg = str(err)
    if "data check" in msg:
        return 3
    if "length check" in msg:
        return 4
    if "header" in msg or "compression method" in msg:
        return 2
    return 1


def inflate_plain(comp: torch.Tensor, table: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``inflate_members`` on the host: zlib in gzip mode per member (it
    checks the trailer's CRC32 and ISIZE), the output held to each row's
    out_size."""
    data = comp.numpy().tobytes()
    rows = table.numpy()
    total = int((rows[:, 2] + rows[:, 3]).max()) if len(rows) else 0
    out = np.zeros(total, np.uint8)
    status = np.zeros(len(rows) + 1, np.int32)
    for i, (a, n, o, m) in enumerate(rows.tolist()):
        d = zlib.decompressobj(31)
        try:
            got = d.decompress(data[a:a + n], m + 1)
            st = 0 if d.eof else 1
        except zlib.error as e:
            got, st = b"", _status_of(e)
        if st == 0 and len(got) != m:
            st = 4
        if st == 0:
            out[o:o + m] = np.frombuffer(got, np.uint8)
        status[i] = st
    status[-1] = status[:-1].max(initial=0)
    return torch.from_numpy(out), torch.from_numpy(status)


def inflate_members(comp: torch.Tensor, table: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The members of `comp` that `table` lists, inflated: (out uint8, the
    n statuses and the worst, int32).  The kernel on a CUDA tensor, zlib
    (``inflate_plain``) on a CPU one."""
    if comp.dtype != torch.uint8 or comp.dim() != 1:
        raise TypeError("comp must be a 1-d uint8 tensor")
    if table.dtype != torch.int64 or table.dim() != 2 or \
            table.shape[1] != 4:
        raise TypeError("table must be an (n, 4) int64 tensor")
    if table.device != comp.device:
        raise ValueError("comp and table must share one device")
    if comp.device.type == "cpu":
        return inflate_plain(comp, table.contiguous())
    if comp.device.type != "cuda":
        raise ValueError(f"no BGZF inflate kernel for device {comp.device}")
    rows = table.cpu()
    n = rows.shape[0]
    if n and (int(rows[:, 0].min()) < 0 or
              int((rows[:, 0] + rows[:, 1]).max()) > comp.numel()):
        raise ValueError("table rows run past comp")
    total = int((rows[:, 2] + rows[:, 3]).max()) if n else 0
    padded = torch.zeros(comp.numel() + _PAD, dtype=torch.uint8,
                         device=comp.device)
    padded[:comp.numel()] = comp
    out = torch.empty(total, dtype=torch.uint8, device=comp.device)
    status = torch.zeros(n + 1, dtype=torch.int32, device=comp.device)
    t = table.contiguous()
    rc = _library().duet_bgzf_launch(
        padded.data_ptr(), t.data_ptr(), n, out.data_ptr(),
        status.data_ptr(), torch.cuda.current_stream(comp.device).cuda_stream)
    if rc != 0:
        raise CardInflateError("bgzf_inflate kernel launch failed: " +
                               _library().duet_bgzf_error_string(rc).decode())
    return out, status


# duet_bgzf_stats' fields
_STATS = ("launches", "members", "h2d_bytes", "d2h_bytes", "h2d_s",
          "compute_s", "d2h_s")


class CardInflater:
    """The native reader's inflater on the card `device`: batch buffers of
    BATCH_IN compressed and BATCH_OUT inflated bytes and BATCH_MEMBERS
    table rows on the card (torch) and a C context over them on the
    current stream; `threads` host threads fault in the reader's pages
    while a batch decodes.  ``attach`` hands it to a reader handle, and
    ``close`` frees both."""

    def __init__(self, device: torch.device, threads: int):
        from duet_tpu_torch.device import require

        try:
            require(device)
            lib = _library()
            index = device.index if device.index is not None \
                else torch.cuda.current_device()
            dev = torch.device("cuda", index)
            self._comp = torch.empty(BATCH_IN + _PAD, dtype=torch.uint8,
                                     device=dev)
            self._out = torch.empty(BATCH_OUT, dtype=torch.uint8, device=dev)
            self._table = torch.empty((BATCH_MEMBERS, 4), dtype=torch.int64,
                                      device=dev)
            self._status = torch.empty(BATCH_MEMBERS + 1, dtype=torch.int32,
                                       device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
        except Exception as e:
            raise CardInflateError(f"BGZF inflate on the card: {e}") from e
        self._lib = lib
        self._ctx = lib.duet_bgzf_ctx_create(
            index, stream, self._comp.data_ptr(), BATCH_IN,
            self._out.data_ptr(), BATCH_OUT, self._table.data_ptr(),
            self._status.data_ptr(), BATCH_MEMBERS, max(int(threads), 1))

    def attach(self, ingest_lib, handle) -> None:
        """Make this the inflater of the reader `handle`."""
        fn = ctypes.cast(self._lib.duet_bgzf_inflate, ctypes.c_void_p)
        ingest_lib.duet_bam_set_inflater(
            ctypes.c_void_p(handle), fn, ctypes.c_void_p(self._ctx),
            BATCH_IN, BATCH_OUT, BATCH_MEMBERS)

    def error(self) -> str | None:
        """The device error that failed a batch, if one did."""
        err = self._lib.duet_bgzf_error(self._ctx)
        return err.decode() if err else None

    def close(self) -> dict:
        """Free the context and the buffers; returns what it did
        (launches, members, bytes and seconds each way)."""
        raw = (ctypes.c_double * len(_STATS))()
        self._lib.duet_bgzf_stats(self._ctx, raw)
        self._lib.duet_bgzf_ctx_destroy(self._ctx)
        self._ctx = None
        del self._comp, self._out, self._table, self._status
        return {k: (v if k.endswith("_s") else int(v))
                for k, v in zip(_STATS, raw)}
