"""Mean seconds a window sample of the neural SNP caller's network: the
program's span ``snp_calling.network`` (model load, upload, forward and
readback in ``models.nn_snp.nn_call_snps``)."""

from h100_bench.spans import span_mean

UNIT = "s"


def read(run):
    return span_mean(run, "snp_calling.network")
