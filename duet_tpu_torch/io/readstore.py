"""Packed column-store of aligned reads: the framework's ingest layer.

The reference re-reads the BAM once per stage and per chromosome through
external tools (samtools text dump at sv_phasing_fn.py:25, whatshap haplotag
--regions per contig at snp_phasing.py:27-29 — the dominant redundant-I/O
cost called out in SURVEY.md §3.3).  Here the BAM is decoded ONCE into a
structure-of-arrays read store; every downstream stage (pileup SNP calling,
SV-signature extraction, allele-matrix construction, haplotagging) consumes
the same packed arrays, and device stages upload slices of them directly.

Layout (per contig):
  starts/ends     (n,) int64   0-based ref span of each read
  strand          (n,) uint8
  mapq            (n,) uint8
  names           list[str]    read names (kept host-side only)
  cigar_ops/lens  ragged int32 via cigar_off offsets
  seq             ragged uint8 base codes via seq_off offsets
  qual            ragged uint8 phred via seq_off offsets
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from duet_tpu_torch.io.bam import (
    CONSUMES_QUERY,
    CONSUMES_REF,
    BamReader,
)


@dataclass
class ContigReads:
    """All mapped alignments of one contig (primary + supplementary),
    packed as columns."""

    contig: str
    n: int
    names: list[str]
    starts: np.ndarray      # (n,) int64
    ends: np.ndarray        # (n,) int64, exclusive
    strand: np.ndarray      # (n,) uint8
    mapq: np.ndarray        # (n,) uint8
    supp: np.ndarray        # (n,) uint8  1 = supplementary alignment
    cigar_off: np.ndarray   # (n+1,) int64 into cigar_ops/cigar_lens
    cigar_ops: np.ndarray   # (total_ops,) int8
    cigar_lens: np.ndarray  # (total_ops,) int32
    seq_off: np.ndarray     # (n+1,) int64 into seq/qual
    seq: np.ndarray         # (total_bases,) uint8 codes A0 C1 G2 T3 N4
    qual: np.ndarray        # (total_bases,) uint8


@dataclass
class ReadStore:
    contigs: dict[str, ContigReads]
    contig_lengths: dict[str, int]

    def names_all(self) -> list[str]:
        out = []
        for c in self.contigs.values():
            out.extend(c.names)
        return out


def pack_contig(contig: str, reads: list) -> ContigReads:
    """Pack a position-sorted list of BamRead into the column layout."""
    reads.sort(key=lambda rd: rd.pos)
    n = len(reads)
    names = [rd.name for rd in reads]
    starts = np.array([rd.pos for rd in reads], dtype=np.int64)
    ends = np.array([rd.ref_end() for rd in reads], dtype=np.int64)
    strand = np.array([(rd.flag >> 4) & 1 for rd in reads], dtype=np.uint8)
    mapq = np.array([rd.mapq for rd in reads], dtype=np.uint8)
    supp = np.array([(rd.flag >> 11) & 1 for rd in reads], dtype=np.uint8)
    cigar_off = np.zeros(n + 1, dtype=np.int64)
    seq_off = np.zeros(n + 1, dtype=np.int64)
    for i, rd in enumerate(reads):
        cigar_off[i + 1] = cigar_off[i] + len(rd.cigar)
        seq_off[i + 1] = seq_off[i] + len(rd.seq_codes)
    cigar_ops = np.empty(cigar_off[-1], dtype=np.int8)
    cigar_lens = np.empty(cigar_off[-1], dtype=np.int32)
    seq = np.empty(seq_off[-1], dtype=np.uint8)
    qual = np.empty(seq_off[-1], dtype=np.uint8)
    for i, rd in enumerate(reads):
        if len(rd.cigar):
            cigar_ops[cigar_off[i]:cigar_off[i + 1]] = rd.cigar[:, 0]
            cigar_lens[cigar_off[i]:cigar_off[i + 1]] = rd.cigar[:, 1]
        seq[seq_off[i]:seq_off[i + 1]] = rd.seq_codes
        qual[seq_off[i]:seq_off[i + 1]] = rd.quals
    return ContigReads(
        contig, n, names, starts, ends, strand, mapq, supp,
        cigar_off, cigar_ops, cigar_lens, seq_off, seq, qual,
    )


def _keep(read, min_mapq: int) -> bool:
    # secondary alignments are duplicates of the primary and are dropped;
    # SUPPLEMENTARY segments are kept — they carry the split-read evidence
    # the SV caller needs for INV/DUP detection (and WhatsHap haplotags
    # them too, reference snp_phasing.py:27 --tag-supplementary)
    from duet_tpu_torch.io.bam import FLAG_SECONDARY

    return (read.is_mapped and not (read.flag & FLAG_SECONDARY)
            and read.mapq >= min_mapq and read.ref_id >= 0)


def load_read_store(bam_path: str, min_mapq: int = 0,
                    only_contigs: set[str] | None = None) -> ReadStore:
    """Single-pass BAM decode -> per-contig packed arrays (primary +
    supplementary mapped alignments; secondary dropped).

    only_contigs restricts decoding to the named contigs (multi-process
    contig ownership: each host holds just its shard's reads)."""
    per: dict[str, list] = {}
    with BamReader(bam_path) as r:
        ref_names = r.header.ref_names
        contig_lengths = dict(zip(ref_names, r.header.ref_lengths))
        wanted = None if only_contigs is None else {
            i for i, n in enumerate(ref_names) if n in only_contigs
        }
        for read in r:
            if wanted is not None and read.ref_id not in wanted:
                continue
            if _keep(read, min_mapq):
                per.setdefault(ref_names[read.ref_id], []).append(read)
    contigs = {c: pack_contig(c, reads) for c, reads in per.items()}
    return ReadStore(contigs, contig_lengths)


def stream_contig_reads(bam_path: str, min_mapq: int = 0):
    """Contig-major streaming decode for memory-bounded whole-genome runs:
    yields (ContigReads, contig_lengths) one contig at a time, holding only
    the current contig's reads in memory.  Requires a coordinate-sorted BAM
    (records of one contig contiguous — the pipeline's input contract)."""
    with BamReader(bam_path) as r:
        ref_names = r.header.ref_names
        contig_lengths = dict(zip(ref_names, r.header.ref_lengths))
        cur_id: int | None = None
        reads: list = []
        for read in r:
            if not _keep(read, min_mapq):
                continue
            if read.ref_id != cur_id:
                if cur_id is not None and reads:
                    yield pack_contig(ref_names[cur_id], reads), contig_lengths
                cur_id = read.ref_id
                reads = []
            reads.append(read)
        if cur_id is not None and reads:
            yield pack_contig(ref_names[cur_id], reads), contig_lengths


def stream_contig_reads_auto(bam_path: str, min_mapq: int = 0,
                             n_threads: int = 1,
                             only_contigs: set[str] | None = None,
                             inflate_device=None):
    """stream_contig_reads with the native streaming decoder when the C++
    library is buildable (bounded rolling buffers, threaded inflate, on the
    card `inflate_device` when one is given, parallel column decode —
    native/duet_ingest.cc), Python fallback otherwise, but never for the
    card's route.  Returns (generator, backend_name)."""
    try:
        from duet_tpu_torch.io.native_ingest import get_lib, stream_read_store_native

        get_lib()  # raises NativeUnavailable before the generator starts
        return stream_read_store_native(
            bam_path, min_mapq, n_threads, only_contigs,
            inflate_device=inflate_device), "native"
    except Exception:
        if inflate_device is not None:
            raise
        gen = stream_contig_reads(bam_path, min_mapq)
        if only_contigs is not None:
            gen = ((cr, ln) for cr, ln in gen if cr.contig in only_contigs)
        return gen, "python"


def prefetch_iter(gen, depth: int = 1):
    """Run `gen` on a background thread: the consumer overlaps with
    production (the streaming pipeline decodes contig N+1 while the
    stages process contig N — decode and stage compute each take tens of
    seconds per chromosome, so overlapping hides the smaller).

    depth=1 bounds LIVE items to exactly two (one being consumed + one
    decoded/queued): the producer must reserve a slot BEFORE decoding the
    next item — gating the queue alone would let a third item
    materialize inside the generator while the queue is full.  The queue
    itself is unbounded (capacity is the semaphore), so the terminal
    DONE/exception puts can never block: abandoning the iterator always
    stops the producer.  Exceptions from the generator re-raise at the
    consumer's next pull."""
    import queue
    import threading

    q: queue.Queue = queue.Queue()
    slots = threading.Semaphore(depth)
    DONE = object()
    stop = threading.Event()

    def worker() -> None:
        it = iter(gen)
        while True:
            while not slots.acquire(timeout=0.5):  # slot BEFORE decoding
                if stop.is_set():
                    return
            if stop.is_set():
                return
            try:
                item = next(it)
            except StopIteration:
                q.put(DONE)
                return
            except BaseException as e:  # surfaced to the consumer
                q.put(e)
                return
            q.put(item)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is DONE:
                break
            if isinstance(item, BaseException):
                raise item
            slots.release()  # freed by taking it off the queue
            yield item
    finally:
        stop.set()


def aligned_segments(cr: ContigReads, i: int) -> np.ndarray:
    """Match (M/=/X) segments of read i as rows [ref_start, query_start, length].

    The coordinate bridge every consumer shares: pileup counting, allele
    lookup at SNP sites, and ref-coverage tests all walk these segments."""
    ops = cr.cigar_ops[cr.cigar_off[i]:cr.cigar_off[i + 1]]
    lens = cr.cigar_lens[cr.cigar_off[i]:cr.cigar_off[i + 1]]
    ref_pos = np.int64(cr.starts[i])
    q_pos = np.int64(0)
    rows = []
    for op, ln in zip(ops, lens):
        is_match = op in (0, 7, 8)
        if is_match:
            rows.append((ref_pos, q_pos, ln))
        if CONSUMES_REF[op]:
            ref_pos += ln
        if CONSUMES_QUERY[op]:
            q_pos += ln
    return np.array(rows, dtype=np.int64).reshape(-1, 3)
