"""Mean seconds a window sample of the neural SNP caller's candidates:
the program's span ``snp_calling.features`` in ``models.nn_snp``.  On a
card (``_nn_call_snps_card``): the upload of the counts and reference
codes, and the candidates built there (``cand_count`` with its scan, the
readback of their number, ``cand_compact``); the feature windows are
built a chunk at a time under ``snp_calling.network``.  On the CPU:
``candidate_sites`` and ``extract_features`` in numpy."""

from h100_bench.spans import span_mean

UNIT = "s"


def read(run):
    return span_mean(run, "snp_calling.features")
