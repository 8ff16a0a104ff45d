"""What decides ``correct`` can fail: the control (the reference in the
program's place, one precision down) comes out not correct, and so does a
run of the harness whose timed path is broken underneath, once for each
fault a cell can have."""

import numpy as np
import pytest

from conftest import small_config
from h100_bench import compare, harness
from h100_bench.reference.control import CONTROL

CELLS = {"q20-20x.auto": "synth-ont-q20-20x",
         "q10-10x.auto": "synth-ont-q10-10x"}


def over(checks: dict) -> list[str]:
    return [k for k, c in checks.items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(tmp_path, small_data, cell):
    c = harness.load_cell(cell)
    checks = compare.control_checks(small_data[CELLS[cell]], str(tmp_path),
                                     "auto", c.limits, CONTROL)
    assert over(checks), checks


def state_unchanged(monkeypatch):
    """The read scoring returns every read's tag as it started: untagged."""
    import duet_tpu_torch.models.snp_phaser as m

    def untouched(am, phase, block_id, block_ps):
        n = am.n_reads
        return (np.zeros(n, np.int8), np.full(n, -1, np.int64),
                np.full(n, -1, np.int32))

    monkeypatch.setattr(m, "_haplotag", untouched)


def half_left_out(monkeypatch):
    """The SNP caller counts the first half of each contig only."""
    import duet_tpu_torch.models.snp_caller as m

    real = m.call_snps_any

    def half(contig, counts, ref_codes, cfg, nn_device=None, **kw):
        counts = counts.copy()
        counts[len(counts) // 2:] = 0
        return real(contig, counts, ref_codes, cfg, nn_device, **kw)

    monkeypatch.setattr(m, "call_snps_any", half)


def answer_altered(monkeypatch):
    """One called site's genotype flips where it is called."""
    import duet_tpu_torch.models.snp_caller as m

    real = m.call_snps_any

    def flipped(*args, **kw):
        snps = real(*args, **kw)
        if len(snps.is_het):
            snps.is_het = snps.is_het.copy()
            snps.is_het[len(snps.is_het) // 2] ^= True
        return snps

    monkeypatch.setattr(m, "call_snps_any", flipped)


FAULTS = {"none": None, "state_unchanged": state_unchanged,
          "half_left_out": half_left_out, "answer_altered": answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_harness_run_with_a_broken_timed_path(tmp_path, monkeypatch, cell,
                                              fault):
    c = harness.load_cell(cell)
    c.config_path = small_config(CELLS[cell], str(tmp_path))
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    result = harness.run_cell(c, 977, 0.5, traced=False, device="cpu",
                              work_root=str(tmp_path))
    assert result["attempted"] >= 1
    assert result["correct"] == (fault == "none"), result["checks"]
    assert np.isfinite([m["value"] for m in result["metrics"].values()]).all()
