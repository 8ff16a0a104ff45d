"""One reader a metric, named as the metric is in ``BENCHMARK.json``.

A reader module defines ``UNIT`` and ``read(run)``, which takes the
harness's ``Run`` and returns the metric's value, or None when the run has
nothing for it to read (the harness then leaves the metric out)."""


def stage_mean(run, stage: str) -> float:
    """The mean over the window's samples of one stage's seconds on the
    harness's clock (``clock.stage_clock``).  A window sample without the
    stage is a fault, never a gap to skip."""
    missing = sum(1 for s in run.sample_stages if stage not in s)
    if missing or not run.sample_stages:
        raise RuntimeError(f"stage {stage!r} not timed in {missing} of "
                           f"{len(run.sample_stages)} window samples")
    return sum(s[stage] for s in run.sample_stages) / len(run.sample_stages)


def cold_peak(run, stage: str) -> float:
    """The high-water mark in MB as `stage` ended in the run's first
    sample (``clock.stage_clock``); a missing stage is a fault."""
    if stage not in run.cold_peaks:
        raise RuntimeError(f"stage {stage!r} not seen in the first sample")
    return run.cold_peaks[stage]
