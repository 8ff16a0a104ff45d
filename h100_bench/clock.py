"""The harness's own clock around each stage of the program.

A batch sample (``pipeline.run_pipeline``) runs with
``duet_tpu_torch.pipeline``'s BAM ingest (``_ingest``) and each entry of
its ``STAGES`` wrapped: the wrapper reads ``time.perf_counter`` on
entering and leaving, and opens a ``record_function`` range
``stage:<stage>`` that a traced sample's profiler records.

A stream sample (``pipeline.run_pipeline_streaming``) calls neither: its
loop takes one contig at a time through every stage but the last.  There
the clock wraps, by name, what the loop calls for each stage, and each
key sums that stage's pieces over the contigs:

- ``ingest``: each ``next`` on the contig iterator (the decode, or with
  the loop's prefetch the wait for it; the last ``next`` ends the
  stream), and the genome FASTA's ``FastaFile.fetch_codes``;
- ``snp_calling``: ``models.snp_caller.call_contig_snps``;
- ``sv_calling``: ``pipeline.call_contig_with_evidence``;
- ``snp_phasing``: ``pipeline._sv_protect_intervals``, ``phase_contig``
  and ``read_hap_map``, and the contig's writes ``write_phased_snp_vcf``
  and ``_write_haplotag_table``;
- ``sv_phasing``: ``pipeline.stage_sv_phasing``, once.

Work between the timed pieces is outside every key: the per-contig SNP
config and the release of a contig, and after the loop the pileup VCF's
and the SV VCF's writes with the breakend calls.

The stage seconds are the harness's readings, not the program's own
timers, so a later change to the program's timers moves no metric.  A
name the program no longer has makes the sample fail.  The clock also
reads the process's high-water mark (``ru_maxrss``) as each timed piece
ends: in a process's first sample, the stage where it rises is the one
that set it.
"""

from __future__ import annotations

import resource
import time
from contextlib import contextmanager

STAGE_PREFIX = "stage:"
# the names the streaming loop looks up in duet_tpu_torch.pipeline as it
# runs, each timed under its stage
STREAM_PIPELINE_NAMES = (
    ("call_contig_with_evidence", "sv_calling"),
    ("_sv_protect_intervals", "snp_phasing"),
    ("phase_contig", "snp_phasing"),
    ("read_hap_map", "snp_phasing"),
    ("write_phased_snp_vcf", "snp_phasing"),
    ("_write_haplotag_table", "snp_phasing"),
    ("stage_sv_phasing", "sv_phasing"),
)


def stage_key(name: str) -> str:
    """``"SNP CALLING"`` -> ``"snp_calling"``."""
    return name.lower().replace(" ", "_")


def peak_mb() -> float:
    """The process's high-water mark in MB (ru_maxrss is KB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def _timed(key: str, fn, times: dict, peaks: dict):
    from torch.profiler import record_function

    def wrapped(*args, **kwargs):
        t = time.perf_counter()
        try:
            with record_function(STAGE_PREFIX + key):
                return fn(*args, **kwargs)
        finally:
            times[key] = times.get(key, 0.0) + time.perf_counter() - t
            peaks[key] = peak_mb()

    return wrapped


class _Pulls:
    """An iterator over `inner` whose every ``next`` runs through `pull`."""

    def __init__(self, inner, pull):
        self.inner, self.pull = inner, pull

    def __iter__(self):
        return self

    def __next__(self):
        return self.pull(self.inner)


def _batch_patches(pipeline, times: dict, peaks: dict) -> list:
    return [
        (pipeline, "STAGES", tuple(
            (name, _timed(stage_key(name), fn, times, peaks))
            for name, fn in pipeline.STAGES)),
        (pipeline, "_ingest", _timed("ingest", pipeline._ingest, times,
                                     peaks)),
    ]


def _stream_patches(pipeline, times: dict, peaks: dict) -> list:
    from duet_tpu_torch.io import readstore
    from duet_tpu_torch.models import snp_caller

    pull = _timed("ingest", next, times, peaks)
    stream_reads, prefetch = (readstore.stream_contig_reads_auto,
                              readstore.prefetch_iter)

    def timed_stream(*args, **kwargs):
        gen, backend = stream_reads(*args, **kwargs)
        return _Pulls(gen, pull), backend

    def timed_prefetch(gen, *args, **kwargs):
        # time the loop's wait for the decoding thread, not the decode
        return _Pulls(prefetch(gen.inner, *args, **kwargs), pull)

    class TimedFasta(pipeline.FastaFile):
        fetch_codes = _timed("ingest", pipeline.FastaFile.fetch_codes,
                             times, peaks)

    return [
        (readstore, "stream_contig_reads_auto", timed_stream),
        (readstore, "prefetch_iter", timed_prefetch),
        (pipeline, "FastaFile", TimedFasta),
        (snp_caller, "call_contig_snps", _timed(
            "snp_calling", snp_caller.call_contig_snps, times, peaks)),
    ] + [(pipeline, name, _timed(key, getattr(pipeline, name), times, peaks))
         for name, key in STREAM_PIPELINE_NAMES]


@contextmanager
def stage_clock(times: dict, peaks: dict | None = None,
                entry: str = "batch"):
    """Within the block, each stage's seconds add up in `times` under its
    key (``ingest``, ``snp_calling``, ...), and `peaks` takes the
    high-water mark in MB as the stage ends; `entry` is the sample's entry
    point, ``batch`` or ``stream``."""
    from duet_tpu_torch import pipeline

    peaks = {} if peaks is None else peaks
    patches = (_stream_patches if entry == "stream" else _batch_patches)(
        pipeline, times, peaks)
    saved = [(owner, name, getattr(owner, name))
             for owner, name, _ in patches]
    for owner, name, new in patches:
        setattr(owner, name, new)
    try:
        yield times
    finally:
        for owner, name, old in saved:
            setattr(owner, name, old)
