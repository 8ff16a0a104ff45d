"""Warm wall seconds per sample: from the start of the window to the end
of its last whole sample, over the number of samples (host clock)."""

UNIT = "s"


def read(run):
    return run.window_s / len(run.sample_s) if run.sample_s else None
