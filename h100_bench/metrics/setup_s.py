"""Seconds from the process's start to the window's: the simulated input,
the program's build, imports, the cold sample and one warm-up sample."""

UNIT = "s"


def read(run):
    return run.setup_s or None
