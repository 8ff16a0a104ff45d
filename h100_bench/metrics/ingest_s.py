"""Mean seconds of the pipeline's ingest stage over the
window's samples, on the harness's clock around the stage
(``pipeline._ingest``, the BAM decode; ``clock.stage_clock``)."""

from h100_bench.metrics import stage_mean

UNIT = "s"


def read(run):
    return stage_mean(run, "ingest")
