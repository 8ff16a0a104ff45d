"""Mean seconds a window sample of writing the artifacts: the program's
``write.<artifact>`` spans together, one a writer (the tabix index, span
``index.tabix``, is inside the VCF writers' spans and not counted
again)."""

from h100_bench.spans import spans_mean

UNIT = "s"


def read(run):
    return spans_mean(run, "write.")
