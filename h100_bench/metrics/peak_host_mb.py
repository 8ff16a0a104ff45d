"""The measuring process's peak resident set (ru_maxrss, in MB of 2^20
bytes), read after the window: the cold sample, the warm-up and every
window sample; the simulator runs in a child process."""

UNIT = "MB"


def read(run):
    return run.peak_host_mb or None
