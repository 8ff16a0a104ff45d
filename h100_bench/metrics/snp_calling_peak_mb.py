"""The process's high-water mark in MB as SNP calling (its entry of
``pipeline.STAGES``) ends in the run's first sample, on the harness's
clock (``clock.stage_clock``): what the process holds by the end of that
layer, the part of ``peak_host_mb`` it sets."""

from h100_bench.metrics import cold_peak

UNIT = "MB"


def read(run):
    return cold_peak(run, "snp_calling")
