"""Share of the traced window in which no kernel, memcpy or memset ran on
the card, in percent: torch.profiler over the traced samples, the union
of the device intervals (``trace.device_busy``).  A traced run whose card
ran nothing fails in the harness before this is read."""

UNIT = "%"


def read(run):
    t = run.trace
    if t is None:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
