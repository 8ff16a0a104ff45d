"""Mean seconds a window sample of the native ingest's BGZF inflate: the
program's counter ``ingest.inflate_s``, the C++ reader's wall clock over
its inflate pool (``csrc/duet_ingest.cc``)."""

from h100_bench.spans import counter_mean

UNIT = "s"


def read(run):
    return counter_mean(run, "ingest.inflate_s")
