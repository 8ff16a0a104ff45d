"""The plain reference writes the program's artifacts: the program on the
CPU with every stage on the host (``--device cpu --device-stages off``)
and the reference agree line for line at a test size."""

import os

import pytest

from conftest import TEST_CONTIGS
from h100_bench import compare
from h100_bench.reference.pipeline import RunFlags, run_reference

LIMITS = {"snp_calling_lines": 0, "sv_calling_lines": 0,
          "snp_phasing_lines": 0, "sv_phasing_lines": 0, "snp_nn_gap": 0.0}


@pytest.mark.parametrize("name", ["synth-ont-q20-20x", "synth-ont-q10-10x"])
@pytest.mark.parametrize("follow", [False, True])
def test_reference_equals_the_host_route(tmp_path, small_data, name, follow):
    from duet_tpu_torch.pipeline import PipelineConfig, run_pipeline

    data = small_data[name]
    bam, fa = os.path.join(data, "reads.bam"), os.path.join(data, "ref.fa")
    port = str(tmp_path / "port")
    run_pipeline(PipelineConfig(bam=bam, reference=fa, output=port,
                                device="cpu", device_stages="off"))
    pileup = os.path.join(port, "snp_calling", "pileup.vcf.gz")
    ref = run_reference(bam, fa, str(tmp_path / "ref"), RunFlags(),
                        follow=pileup if follow else None)
    checks = compare.judge(port, ref.out_dir, ref.nn, LIMITS)
    assert all(c["value"] == 0 for c in checks.values()), checks
    assert bool(ref.nn) == (name == "synth-ont-q10-10x")
    contigs = len(TEST_CONTIGS[name])
    assert len(compare.port_artifacts(port)) == 3 + 2 * contigs


def test_counting_rule_phases_the_references_own_calls(tmp_path, small_data):
    """Under the counting rule the reference takes nothing from the
    program: a followed pileup with every call removed changes nothing."""
    data = small_data["synth-ont-q20-20x"]
    bam, fa = os.path.join(data, "reads.bam"), os.path.join(data, "ref.fa")
    own = run_reference(bam, fa, str(tmp_path / "own"), RunFlags())
    assert not own.nn
    pileup = os.path.join(own.out_dir, "snp_calling", "pileup.vcf")
    empty = str(tmp_path / "empty.vcf")
    with open(pileup) as src, open(empty, "w") as dst:
        dst.writelines(line for line in src if line.startswith("#"))
    followed = run_reference(bam, fa, str(tmp_path / "followed"), RunFlags(),
                             follow=empty)
    checks = compare.judge(followed.out_dir, own.out_dir, {}, LIMITS)
    assert all(c["value"] == 0 for c in checks.values()), checks
