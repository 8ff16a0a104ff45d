"""Mean seconds of the pipeline's sv calling stage over the
window's samples, on the harness's clock around the stage
(its entry of ``pipeline.STAGES``; ``clock.stage_clock``)."""

from h100_bench.metrics import stage_mean

UNIT = "s"


def read(run):
    return stage_mean(run, "sv_calling")
