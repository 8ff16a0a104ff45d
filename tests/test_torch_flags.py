"""The byte-identity contract under each CLI flag: duet-tpu-torch and
duet-tpu on the same simulated BAM under --device-stages on, one flag per
case, write the same artifacts (the per-contig haplotagged BAMs and the
tabix indexes included).  The tolerance is none."""

import pytest

from duet_tpu.cli import main as jax_cli
from duet_tpu_torch.cli import main as torch_cli
from test_torch_modes import artifact_tree

FLAGS = [
    ["--haplotag-bam"],
    ["--snp-model", "nn"],
    ["-b", "svim"],
    ["-b", "sniffles"],
    ["-a"],
    ["--phase-bnd"],
    ["--decision-model", "learned"],
    ["--junction-split", "off"],
    ["--min-junction-evidence", "5"],
    ["--host-kernel"],
]


@pytest.mark.parametrize("flags", FLAGS, ids=[" ".join(f) for f in FLAGS])
def test_flag_artifacts_match_duet_tpu(sim_dataset, tmp_path, flags):
    data = sim_dataset[0]
    inputs = [f"{data}/reads.bam", f"{data}/ref.fa"]
    common = ["--device-stages", "on", *flags]
    assert jax_cli([*inputs, str(tmp_path / "jax"), *common]) == 0
    assert torch_cli([*inputs, str(tmp_path / "torch"), "--device", "cpu",
                      *common]) == 0
    got, want = artifact_tree(tmp_path / "torch"), \
        artifact_tree(tmp_path / "jax")
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    if flags == ["--haplotag-bam"]:
        assert "snp_phasing/chr21.bam" in got
