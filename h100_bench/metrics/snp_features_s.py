"""Mean seconds a window sample of the neural SNP caller's host features:
the program's span ``snp_calling.features`` (``candidate_sites`` and
``extract_features`` in ``models.nn_snp.nn_call_snps``)."""

from h100_bench.spans import span_mean

UNIT = "s"


def read(run):
    return span_mean(run, "snp_calling.features")
