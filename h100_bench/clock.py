"""The harness's own clock around each stage of the program.

Every sample runs with ``duet_tpu_torch.pipeline``'s BAM ingest
(``_ingest``) and each entry of its ``STAGES`` wrapped: the wrapper reads
``time.perf_counter`` on entering and leaving, and opens a
``record_function`` range ``stage:<stage>`` that a traced sample's
profiler records.  The stage seconds are the harness's readings, not the
program's own timers, so a later change to the program's timers moves no
metric.  A name the program no longer has makes the sample fail.  The
clock also reads the process's high-water mark (``ru_maxrss``) as each
stage ends: in a process's first sample, the stage where it rises is the
one that set it.
"""

from __future__ import annotations

import resource
import time
from contextlib import contextmanager

STAGE_PREFIX = "stage:"


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


@contextmanager
def stage_clock(times: dict, peaks: dict | None = None):
    """Within the block, each stage's seconds add up in `times` under its
    key (``ingest``, ``snp_calling``, ...), and `peaks` takes the
    high-water mark in MB as the stage ends."""
    from duet_tpu_torch import pipeline

    peaks = {} if peaks is None else peaks
    stages, ingest = pipeline.STAGES, pipeline._ingest
    pipeline.STAGES = tuple(
        (name, _timed(stage_key(name), fn, times, peaks))
        for name, fn in stages)
    pipeline._ingest = _timed("ingest", ingest, times, peaks)
    try:
        yield times
    finally:
        pipeline.STAGES, pipeline._ingest = stages, ingest
