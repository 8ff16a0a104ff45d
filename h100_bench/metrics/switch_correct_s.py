"""Mean seconds a window sample of SNP phasing's switch correction: the
program's span ``snp_phasing.switch_correct`` inside ``phase_contig_core``
(the corrector's tables, then each refine-and-correct round's correction;
the refine sweeps between rounds are outside it).  A program whose samples
carry the span registry without this span (one older than the span) gives
nothing to read; some samples with it and some without is a fault
(``spans.span_mean``)."""

from h100_bench.spans import span_mean

UNIT = "s"
SPAN = "snp_phasing.switch_correct"


def read(run):
    samples = run.sample_metrics
    if samples and not any(SPAN in m.get("spans", {}) for m in samples):
        return None
    return span_mean(run, SPAN)
