"""ctypes bridge to the native ingest library (csrc/duet_ingest.cc).

Loads libduet_ingest.so (building it with g++ on first use if the
toolchain is present) and exposes the STREAMING contig iterator the C++
core implements: bounded rolling buffers, threaded BGZF inflate (or, given
a card, the card's: ``ops.bgzf_inflate``), parallel record-to-column
decode, and an in-decoder contig filter.  On top of it:

  stream_read_store_native   generator of (ContigReads, contig_lengths) —
                             the native backend of readstore.stream_contig_reads
  load_read_store_native     whole-file ReadStore (drop-in for
                             readstore.load_read_store), only_contigs
                             honored DURING decode
  decode_stats               the decodes' phase timers and volumes, which
                             each decode adds as ``ingest.*`` counters of
                             ``utils.spans`` when its stream closes

Falls back to the Python path when the library can't be built
(NativeUnavailable).

The library is built from the port's own copy of the ingest source,
``duet_tpu_torch/csrc/duet_ingest.cc``: ``native/duet_ingest.cc`` verbatim
but for its BGZF member inflate, which calls zlib (one reusable
``z_stream`` per thread, the gzip trailer's CRC32 and ISIZE checked, the
empty EOF member's too) where the original links a separate inflate
library, so it builds and loads on any host with zlib, or hands whole
batches of members to an inflater (``duet_bam_set_inflater``: the card's,
``ops.bgzf_inflate``), and for ``duet_bam_release``, which the stream
calls once a contig is copied out, so that the reader does not hold it a
second time while the consumer works on it.  It is compiled with native/Makefile's
compiler flags, linked against zlib alone, into
``build/duet_tpu_torch/native-<hash>/`` (keyed by a hash of the source and
flags), so that this package never loads an object another package
built."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

import numpy as np

from duet_tpu_torch.io.readstore import ContigReads, ReadStore
from duet_tpu_torch.utils import devcost, dispatch, spans

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "duet_tpu_torch", "csrc", "duet_ingest.cc")
_BUILD_ROOT = os.path.join(_REPO_ROOT, "build", "duet_tpu_torch")
# native/Makefile's CXXFLAGS; its LDFLAGS but for the inflate library
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
_LDFLAGS = ("-shared", "-lz", "-lpthread")

_lib = None


class NativeUnavailable(RuntimeError):
    pass


class _RuWindow:
    """Accumulates getrusage deltas over just the DECODE calls of a
    streaming generator, so interleaved stage work between yields does not
    pollute the decode's fault/CPU attribution.  (With the prefetch
    thread active the process-wide counters still mix in concurrent stage
    CPU; on multi-core hosts read these as upper bounds.)"""

    def __init__(self):
        self.utime = self.stime = 0.0
        self.minflt = self.majflt = 0
        self._t = None

    def __enter__(self):
        import resource

        self._t = resource.getrusage(resource.RUSAGE_SELF)
        return self

    def __exit__(self, *exc):
        import resource

        r = resource.getrusage(resource.RUSAGE_SELF)
        self.utime += r.ru_utime - self._t.ru_utime
        self.stime += r.ru_stime - self._t.ru_stime
        self.minflt += r.ru_minflt - self._t.ru_minflt
        self.majflt += r.ru_majflt - self._t.ru_majflt


# the native decode's counters (utils.spans, each ``ingest.<key>``): the
# reader's phase timers and volumes from duet_bam_stats, in its order, then
# the getrusage deltas across the decode calls, the Python-side fetch and
# the members the card inflated
_STATS = ("fread_s", "inflate_s", "scan_s", "size_s", "fill_s",
          "bytes_compressed", "bytes_inflated", "bgzf_members",
          "inflate_batches")
_DECODE_KEYS = _STATS + ("minor_faults", "major_faults", "cpu_user_s",
                         "cpu_kernel_s", "py_fetch_s", "inflate_card_members")


def _count_stats(lib, h, ru: "_RuWindow", py_fetch_s: float,
                 card: dict | None) -> None:
    raw = (ctypes.c_double * len(_STATS))()
    lib.duet_bam_stats(ctypes.c_void_p(h), raw)
    values = [*raw, ru.minflt, ru.majflt, ru.utime, ru.stime, py_fetch_s,
              card["members"] if card else 0]
    for key, v in zip(_DECODE_KEYS, values):
        spans.count("ingest." + key, v if key.endswith("_s") else int(v))
    if card and card["launches"]:
        # the card's copies and decode, timed in the inflater
        n = card["launches"]
        devcost.record("ingest", "h2d", card["h2d_s"], n, card["h2d_bytes"])
        devcost.record("ingest", "compute", card["compute_s"], n)
        devcost.record("ingest", "d2h", card["d2h_s"], n, card["d2h_bytes"])


def decode_stats() -> dict | None:
    """The interior cost split of the native decodes in the current window
    of ``utils.spans`` (summed over them), as metrics.json's ingest block
    carries it: the reader's phase seconds and volumes, the page faults
    and user vs kernel CPU seconds across the decode calls (all threads:
    when kernel time rivals user time and the decode's wall is about
    their sum over the cores, the decode is paging-bound, not
    compute-bound), and the Python side of each contig's fetch (buffer
    allocation and read names around duet_bam_fill, which is inside
    fill_s).  None when no native decode ran."""
    counters = spans.snapshot("ingest.")["counters"]
    if "ingest.inflate_s" not in counters:
        return None
    out = {}
    for key in _DECODE_KEYS:
        v = counters["ingest." + key]
        out[key] = round(v, 2) if key.startswith("cpu_") else \
            round(v, 4) if key.endswith("_s") else int(v)
    return out


def _so_path() -> str:
    """Where the library for this source and these flags lives."""
    if not os.path.exists(_SRC):
        raise NativeUnavailable(f"native source missing: {_SRC}")
    h = hashlib.sha256(" ".join(_CXXFLAGS + _LDFLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_ROOT, f"native-{h.hexdigest()[:16]}",
                        "libduet_ingest.so")


def _build(so: str) -> None:
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_CXXFLAGS, _SRC, "-o", tmp, *_LDFLAGS],
                       check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise NativeUnavailable(f"native build failed: {detail}") from e
    os.replace(tmp, so)  # atomic: a concurrent loader never sees a torn file


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    so = _so_path()
    if not os.path.exists(so):
        _build(so)
    lib = ctypes.CDLL(so)
    lib.duet_bam_open.restype = ctypes.c_void_p
    lib.duet_bam_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.duet_bam_error.restype = ctypes.c_char_p
    lib.duet_bam_error.argtypes = [ctypes.c_void_p]
    lib.duet_bam_n_refs.restype = ctypes.c_int32
    lib.duet_bam_n_refs.argtypes = [ctypes.c_void_p]
    lib.duet_bam_ref_name.restype = ctypes.c_char_p
    lib.duet_bam_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.duet_bam_ref_length.restype = ctypes.c_int32
    lib.duet_bam_ref_length.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.duet_bam_set_filter.restype = None
    lib.duet_bam_set_filter.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int32),
                                        ctypes.c_int32]
    lib.duet_bam_set_compact.restype = None
    lib.duet_bam_set_inflater.restype = None
    lib.duet_bam_set_inflater.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_int64, ctypes.c_int64]
    lib.duet_bam_set_compact.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int64]
    lib.duet_bam_next_contig.restype = ctypes.c_int32
    lib.duet_bam_next_contig.argtypes = [ctypes.c_void_p]
    lib.duet_bam_n_reads.restype = ctypes.c_int64
    lib.duet_bam_n_reads.argtypes = [ctypes.c_void_p]
    lib.duet_bam_ragged_sizes.restype = None
    lib.duet_bam_ragged_sizes.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_int64)]
    lib.duet_bam_fill.restype = None
    lib.duet_bam_stats.restype = None
    lib.duet_bam_stats.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_double)]
    lib.duet_bam_close.restype = None
    lib.duet_bam_close.argtypes = [ctypes.c_void_p]
    lib.duet_bam_release.restype = None
    lib.duet_bam_release.argtypes = [ctypes.c_void_p]
    lib.duet_bam_held_bytes.restype = ctypes.c_int64
    lib.duet_bam_held_bytes.argtypes = [ctypes.c_void_p]
    lib.duet_pileup_sizes.restype = None
    lib.duet_pileup_fill.restype = None
    lib.duet_pileup_counts_only.restype = None
    lib.duet_candidate_scan.restype = ctypes.c_int64
    lib.duet_fasta_codes.restype = ctypes.c_int32
    lib.duet_fasta_codes.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_void_p]
    _lib = lib
    return lib


def fasta_codes_native(path: str, offset: int, length: int, linebases: int,
                       linewidth: int) -> np.ndarray:
    """One-pass FASTA contig -> uint8 base codes (FastaFile.fetch_codes
    twin; the numpy path makes ~4 passes over the bytes)."""
    lib = get_lib()
    out = np.empty(int(length), np.uint8)
    rc = lib.duet_fasta_codes(path.encode(), ctypes.c_int64(int(offset)),
                              ctypes.c_int64(int(length)),
                              ctypes.c_int64(int(linebases)),
                              ctypes.c_int64(int(linewidth)), _ptr(out))
    if rc != 0:
        raise ValueError(f"{path}: FASTA read failed (code {rc}; "
                         "truncated file or bad .fai entry)")
    return out


def candidate_scan_native(counts: np.ndarray, ref_codes: np.ndarray,
                          min_depth: int, min_alt: int,
                          n_threads: int | None = None):
    """Single-pass threaded candidate-site scan over the (L, 4) count image
    (the site-calling pre-filter) — numpy-identical outputs
    (pos, alt_code, alt_count, depth), without the numpy path's
    gigabyte-scale full-image temporaries at chromosome L."""
    lib = get_lib()
    L = len(ref_codes)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    ref = np.ascontiguousarray(ref_codes, dtype=np.uint8)
    if counts.shape != (L, 4):
        raise ValueError("counts must be (L, 4)")
    if n_threads is None:
        n_threads = max(os.cpu_count() or 1, 1)
    cap = max(L // 4, 1 << 16)
    pos = np.empty(cap, dtype=np.int64)
    alt_code = np.empty(cap, dtype=np.int32)
    alt_count = np.empty(cap, dtype=np.int32)
    depth = np.empty(cap, dtype=np.int32)
    n = lib.duet_candidate_scan(
        _ptr(counts), _ptr(ref), ctypes.c_int64(L),
        ctypes.c_int32(int(min_depth)), ctypes.c_int32(int(min_alt)),
        ctypes.c_int64(cap), _ptr(pos), _ptr(alt_code), _ptr(alt_count),
        _ptr(depth), ctypes.c_int32(n_threads))
    if n < 0:
        raise RuntimeError("candidate scan overflow: more than L/4 "
                           "candidate sites (degenerate input)")
    return pos[:n], alt_code[:n], alt_count[:n], depth[:n]


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _fetch_contig(lib, h, name: str) -> ContigReads:
    n = lib.duet_bam_n_reads(h)
    sizes = (ctypes.c_int64 * 3)()
    lib.duet_bam_ragged_sizes(h, sizes)
    nb, nc, ns = sizes[0], sizes[1], sizes[2]
    pos = np.empty(n, np.int64)
    end = np.empty(n, np.int64)
    mapq = np.empty(n, np.uint8)
    flag = np.empty(n, np.uint16)
    name_off = np.empty(n + 1, np.int64)
    name_bytes = np.empty(nb, np.uint8)
    cigar_off = np.empty(n + 1, np.int64)
    cigar_ops = np.empty(nc, np.int8)
    cigar_lens = np.empty(nc, np.int32)
    seq_off = np.empty(n + 1, np.int64)
    seq_codes = np.empty(ns, np.uint8)
    quals = np.empty(ns, np.uint8)
    lib.duet_bam_fill(
        ctypes.c_void_p(h), _ptr(pos), _ptr(end), _ptr(mapq), _ptr(flag),
        _ptr(name_off), _ptr(name_bytes), _ptr(cigar_off), _ptr(cigar_ops),
        _ptr(cigar_lens), _ptr(seq_off), _ptr(seq_codes), _ptr(quals),
    )
    text = name_bytes.tobytes().decode()
    off = name_off.tolist()  # python ints: ~3x faster slicing than np.int64
    names = [text[off[k]:off[k + 1]] for k in range(n)]
    cr = ContigReads(
        name, int(n), names, pos, end,
        ((flag >> 4) & 1).astype(np.uint8), mapq,
        ((flag >> 11) & 1).astype(np.uint8),
        cigar_off, cigar_ops, cigar_lens, seq_off, seq_codes, quals,
    )
    if n > 1 and np.any(pos[1:] < pos[:-1]):
        cr = _sort_contig(cr)
    return cr


def _sort_contig(cr: ContigReads) -> ContigReads:
    """Stable position sort for non-coordinate-sorted inputs (parity with
    readstore.pack_contig); coordinate-sorted BAMs skip this entirely."""
    order = np.argsort(cr.starts, kind="stable")
    m = cr.n
    c_off = np.zeros(m + 1, np.int64)
    s_off = np.zeros(m + 1, np.int64)
    np.cumsum(cr.cigar_off[order + 1] - cr.cigar_off[order], out=c_off[1:])
    np.cumsum(cr.seq_off[order + 1] - cr.seq_off[order], out=s_off[1:])
    ops = np.empty(int(c_off[-1]), np.int8)
    lens = np.empty(int(c_off[-1]), np.int32)
    seq = np.empty(int(s_off[-1]), np.uint8)
    qual = np.empty(int(s_off[-1]), np.uint8)
    for k, i in enumerate(order):
        ops[c_off[k]:c_off[k + 1]] = cr.cigar_ops[cr.cigar_off[i]:cr.cigar_off[i + 1]]
        lens[c_off[k]:c_off[k + 1]] = cr.cigar_lens[cr.cigar_off[i]:cr.cigar_off[i + 1]]
        seq[s_off[k]:s_off[k + 1]] = cr.seq[cr.seq_off[i]:cr.seq_off[i + 1]]
        qual[s_off[k]:s_off[k + 1]] = cr.qual[cr.seq_off[i]:cr.seq_off[i + 1]]
    return ContigReads(
        cr.contig, m, [cr.names[i] for i in order],
        cr.starts[order].copy(), cr.ends[order].copy(),
        cr.strand[order].copy(), cr.mapq[order].copy(), cr.supp[order].copy(),
        c_off, ops, lens, s_off, seq, qual,
    )


def stream_read_store_native(bam_path: str, min_mapq: int = 0,
                             n_threads: int | None = None,
                             only_contigs: set[str] | None = None,
                             compact_bytes: int | None = None,
                             on_header=None, inflate_device=None):
    """Generator of (ContigReads, contig_lengths): the native backend of
    readstore.stream_contig_reads.  Peak memory is one contig's columns +
    the decoder's rolling buffers; only_contigs filters at decode time.
    compact_bytes shrinks the rolling-buffer compaction thresholds (tests
    exercise the rebase logic on small inputs with it).  on_header, when
    given, is called with the header's {contig: length} dict as soon as the
    handle opens — callers get the header from THIS open instead of paying
    a second decoder startup (thread pool + first BGZF window) just to read
    it.  inflate_device, a CUDA device, inflates the BGZF members past the
    header on that card (``ops.bgzf_inflate.CardInflater``); None keeps the
    zlib pool.  The bytes inflated are the same either way.  One
    ``dispatch.ingest_inflate.{card,host}`` a decode."""
    lib = get_lib()
    if n_threads is None:
        n_threads = max(os.cpu_count() or 1, 1)
    ru = _RuWindow()
    py_fetch_s = 0.0  # buffer alloc + name decode around duet_bam_fill
    inflater = card = None
    with ru:
        h = lib.duet_bam_open(bam_path.encode(), min_mapq, n_threads)
    try:
        if compact_bytes is not None:
            lib.duet_bam_set_compact(ctypes.c_void_p(h),
                                     ctypes.c_int64(compact_bytes),
                                     ctypes.c_int64(compact_bytes))
        err = lib.duet_bam_error(h)
        if err:
            raise ValueError(f"{bam_path}: {err.decode()}")
        ref_names = [lib.duet_bam_ref_name(h, i).decode()
                     for i in range(lib.duet_bam_n_refs(h))]
        contig_lengths = {
            name: lib.duet_bam_ref_length(h, i)
            for i, name in enumerate(ref_names)
        }
        if on_header is not None:
            on_header(contig_lengths)
        if inflate_device is not None:
            from duet_tpu_torch.ops.bgzf_inflate import CardInflater

            inflater = CardInflater(inflate_device, n_threads)
            inflater.attach(lib, h)
        dispatch.record("ingest_inflate",
                        "host" if inflater is None else "card")
        if only_contigs is not None:
            ids = [i for i, nm in enumerate(ref_names) if nm in only_contigs]
            if not ids:
                # an explicit filter matching nothing keeps NOTHING (e.g. a
                # multi-process run with more processes than contigs); the
                # C API treats n == 0 as "reset", so return before decoding
                return
            arr = (ctypes.c_int32 * len(ids))(*ids)
            lib.duet_bam_set_filter(ctypes.c_void_p(h), arr, len(ids))
        while True:
            with ru:
                rid = lib.duet_bam_next_contig(h)
                if rid == -2:
                    err = lib.duet_bam_error(h)
                    err = err.decode() if err else "decode error"
                    if inflater is not None and inflater.error():
                        from duet_tpu_torch.ops.bgzf_inflate import \
                            CardInflateError

                        raise CardInflateError(
                            f"{bam_path}: {err}: {inflater.error()}")
                    raise ValueError(f"{bam_path}: {err}")
                if rid >= 0:
                    t0 = time.perf_counter()
                    cr = _fetch_contig(lib, h, ref_names[rid])
                    # the contig is in cr alone from here on: the reader
                    # drops its copy before the consumer works on it
                    lib.duet_bam_release(ctypes.c_void_p(h))
                    py_fetch_s += time.perf_counter() - t0
            if rid < 0:
                break
            yield cr, contig_lengths
            del cr  # the consumer's reference is the only one from here
    finally:
        # abandoned-generator cleanup can run at interpreter teardown, when
        # the ctypes function attributes may already be torn down
        try:
            if inflater is not None:
                card = inflater.close()
            _count_stats(lib, h, ru, py_fetch_s, card)
        except Exception:
            pass
        close = getattr(lib, "duet_bam_close", None)
        if close is not None:
            close(ctypes.c_void_p(h))


def bam_contig_lengths_native(bam_path: str) -> dict[str, int]:
    """Header contig lengths without decoding any records."""
    lib = get_lib()
    h = lib.duet_bam_open(bam_path.encode(), 0, 1)
    try:
        err = lib.duet_bam_error(h)
        if err:
            raise ValueError(f"{bam_path}: {err.decode()}")
        return {
            lib.duet_bam_ref_name(h, i).decode(): lib.duet_bam_ref_length(h, i)
            for i in range(lib.duet_bam_n_refs(h))
        }
    finally:
        lib.duet_bam_close(ctypes.c_void_p(h))


def load_read_store_native(bam_path: str, min_mapq: int = 0,
                           n_threads: int | None = None,
                           only_contigs: set[str] | None = None,
                           inflate_device=None) -> ReadStore:
    """Native BAM decode -> per-contig ReadStore (column parity with the
    Python reader; tests pin equality).  A contig split across several
    stream segments (non-coordinate-sorted input) is concatenated and
    re-sorted, matching readstore.load_read_store.  inflate_device as in
    ``stream_read_store_native``."""
    parts: dict[str, list[ContigReads]] = {}
    # header lengths arrive via the stream's own open (they survive even
    # when the ownership filter keeps nothing — the Python reader keeps
    # them too); no second decoder startup just for the header
    header: dict[str, int] = {}
    for cr, lengths in stream_read_store_native(
            bam_path, min_mapq, n_threads, only_contigs,
            on_header=header.update, inflate_device=inflate_device):
        parts.setdefault(cr.contig, []).append(cr)
    contig_lengths = header
    contigs: dict[str, ContigReads] = {}
    for name, segs in parts.items():
        contigs[name] = segs[0] if len(segs) == 1 \
            else _sort_contig(_concat_contigs(name, segs))
    return ReadStore(contigs, contig_lengths)


def _check_contig_span(cr: ContigReads, length: int) -> None:
    """Fail loudly when a read's alignment extends past the contig end —
    the native pileup loops would silently drop those observations while
    the host twin (models.snp_caller.count_alleles) raises; both backends
    must fail the same way on malformed input."""
    if cr.n and int(cr.ends.max()) > int(length):
        raise ValueError(
            f"{cr.contig}: read alignment ends at {int(cr.ends.max())}, "
            f"beyond contig length {int(length)} (malformed BAM/FASTA pair)"
        )


def _pileup_cols(cr: ContigReads):
    return (np.ascontiguousarray(cr.starts, np.int64),
            np.ascontiguousarray(cr.mapq, np.uint8),
            np.ascontiguousarray(cr.cigar_off, np.int64),
            np.ascontiguousarray(cr.cigar_ops, np.int8),
            np.ascontiguousarray(cr.cigar_lens, np.int32),
            np.ascontiguousarray(cr.seq_off, np.int64),
            np.ascontiguousarray(cr.seq, np.uint8),
            np.ascontiguousarray(cr.qual, np.uint8))


def pileup_counts_native(cr: ContigReads, min_mapq: int, min_base_qual: int,
                         length: int) -> np.ndarray:
    """(L, 4) allele-count image in one native pass — the observation
    stream itself is never materialized (models.snp_caller.count_alleles
    parity, pinned by tests)."""
    lib = get_lib()
    _check_contig_span(cr, length)
    starts, mapq, cigar_off, cigar_ops, cigar_lens, seq_off, seq, quals = \
        _pileup_cols(cr)
    counts = np.zeros(int(length) * 4, np.int32)
    lib.duet_pileup_counts_only(
        ctypes.c_int64(cr.n), _ptr(starts), _ptr(mapq),
        ctypes.c_int(min_mapq), _ptr(cigar_off), _ptr(cigar_ops),
        _ptr(cigar_lens), _ptr(seq_off), _ptr(seq), _ptr(quals),
        _ptr(counts), ctypes.c_int64(int(length)),
        ctypes.c_int(min_base_qual))
    return counts.reshape(int(length), 4)


def pileup_obs_native(cr: ContigReads, min_mapq: int, min_base_qual: int = 0,
                      length: int | None = None, n_threads: int | None = None,
                      site_pos: np.ndarray | None = None):
    """Native pileup pass over decoded columns: (positions, bases, quals,
    read_idx) for every M/=/X base, identical layout/order to
    models.snp_caller.pileup_observations, plus — when `length` is given —
    the (L, 4) allele-count image in the same call.

    With `site_pos` (sorted reference positions), only bases landing ON
    those sites are emitted — the at-site slice the phasing stage needs,
    identical to filter_observations_to_sites(pileup_observations(...)).

    Returns (obs_tuple, counts_or_None)."""
    if site_pos is not None and length is not None:
        raise ValueError("counts must come from the unfiltered stream: "
                         "use pileup_counts_native with site_pos filtering")
    lib = get_lib()
    if length is not None:
        _check_contig_span(cr, length)
    if n_threads is None:
        n_threads = max(os.cpu_count() or 1, 1)
    n = cr.n
    starts, mapq, cigar_off, cigar_ops, cigar_lens, seq_off, seq, quals = \
        _pileup_cols(cr)

    lut_ptr = ctypes.c_void_p(None)
    lut_len = 0
    lut = None
    if site_pos is not None:
        top = int(site_pos[-1]) if len(site_pos) else -1
        lut = np.zeros(top + 1, np.uint8)
        if len(site_pos):
            lut[np.asarray(site_pos, np.int64)] = 1
        lut_ptr = _ptr(lut)
        lut_len = top + 1

    per_read = np.empty(n, np.int64)
    lib.duet_pileup_sizes(
        ctypes.c_int64(n), _ptr(starts), _ptr(mapq), ctypes.c_int(min_mapq),
        _ptr(cigar_off), _ptr(cigar_ops), _ptr(cigar_lens),
        lut_ptr, ctypes.c_int64(lut_len), _ptr(per_read))
    out_off = np.zeros(n + 1, np.int64)
    np.cumsum(per_read, out=out_off[1:])
    total = int(out_off[-1])
    pos = np.empty(total, np.int32)
    base = np.empty(total, np.uint8)
    qual = np.empty(total, np.uint8)
    read = np.empty(total, np.int32)
    counts = None
    counts_ptr = ctypes.c_void_p(None)
    L = 0
    if length is not None:
        counts = np.zeros(int(length) * 4, np.int32)
        counts_ptr = _ptr(counts)
        L = int(length)
    lib.duet_pileup_fill(
        ctypes.c_int64(n), _ptr(starts), _ptr(mapq), ctypes.c_int(min_mapq),
        _ptr(cigar_off), _ptr(cigar_ops), _ptr(cigar_lens), _ptr(seq_off),
        _ptr(seq), _ptr(quals), lut_ptr, ctypes.c_int64(lut_len),
        _ptr(out_off), _ptr(pos), _ptr(base),
        _ptr(qual), _ptr(read), counts_ptr, ctypes.c_int64(L),
        ctypes.c_int(min_base_qual), ctypes.c_int(n_threads))
    obs = (pos, base, qual, read)
    return obs, (counts.reshape(L, 4) if counts is not None else None)


def _concat_contigs(name: str, segs: list[ContigReads]) -> ContigReads:
    n = sum(s.n for s in segs)
    names: list[str] = []
    for s in segs:
        names.extend(s.names)

    def cat(field):
        return np.concatenate([getattr(s, field) for s in segs])

    def cat_off(field):
        out = [np.zeros(1, np.int64)]
        base = 0
        for s in segs:
            off = getattr(s, field)
            out.append(off[1:] + base)
            base += int(off[-1])
        return np.concatenate(out)

    return ContigReads(
        name, n, names, cat("starts"), cat("ends"), cat("strand"),
        cat("mapq"), cat("supp"), cat_off("cigar_off"), cat("cigar_ops"),
        cat("cigar_lens"), cat_off("seq_off"), cat("seq"), cat("qual"),
    )
