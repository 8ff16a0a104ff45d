"""Mean seconds a window sample of SNP phasing's refine and switch
correction: the program's span ``snp_phasing.refine`` (the
``phase_contig_core`` pool, or ``phase_contig``'s refine)."""

from h100_bench.spans import span_mean

UNIT = "s"


def read(run):
    return span_mean(run, "snp_phasing.refine")
