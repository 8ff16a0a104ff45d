"""Mean seconds a window sample of the neural SNP caller's network: the
program's span ``snp_calling.network`` in ``models.nn_snp``.  On a card
(``_nn_call_snps_card``): the model's load, then a chunk at a time the
feature windows built there (``cand_features``) and the forward pass,
then the called sites compacted there and their fields read back.  On the
CPU: the model's load, and each chunk's upload, forward and readback."""

from h100_bench.spans import span_mean

UNIT = "s"


def read(run):
    return span_mean(run, "snp_calling.network")
