"""The simulator's copy writes the same bytes for a seed and, with its one
addition (log-uniform SV sizes) off, the bytes the program's own simulator
writes."""

import filecmp
import os

from conftest import TEST_CONTIGS, simulate, small_config

FILES = ("reads.bam", "reads.bam.bai", "ref.fa", "ref.fa.fai", "truth.vcf")


def test_same_bytes_for_a_seed(tmp_path):
    cfg = small_config("synth-ont-q10-10x", str(tmp_path))
    a = simulate(cfg, 2**31 + 7, str(tmp_path / "a"))
    b = simulate(cfg, 2**31 + 7, str(tmp_path / "b"))
    c = simulate(cfg, 2**31 + 8, str(tmp_path / "c"))
    for name in FILES:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name
    assert not filecmp.cmp(os.path.join(a, "reads.bam"),
                           os.path.join(c, "reads.bam"), shallow=False)


def test_same_bytes_as_the_programs_simulator(tmp_path):
    import json

    from duet_tpu_torch.sim import SimConfig, simulate_dataset

    name = "synth-ont-q20-20x"
    with open(small_config(name, str(tmp_path))) as f:
        cfg = json.load(f)
    assert cfg["sim"]["contigs"] == TEST_CONTIGS[name]
    cfg["sim"]["sv_len_log"] = False
    path = str(tmp_path / "uniform.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    copy = simulate(path, 20261017, str(tmp_path / "copy"))
    params = dict(cfg["sim"])
    del params["sv_len_log"]
    out = str(tmp_path / "port")
    simulate_dataset(out, SimConfig(**params, seed=20261017))
    for f in FILES:
        assert filecmp.cmp(os.path.join(out, f), os.path.join(copy, f),
                           shallow=False), f


def test_sv_sizes_log_uniform_within_bounds():
    import numpy as np

    from h100_bench.sim.simulate import SimConfig, _simulate_variants

    cfg = SimConfig(sv_count_per_mb=9.0, sv_len_min=50, sv_len_max=6000,
                    sv_len_log=True)
    rng = np.random.default_rng(5)
    sizes = np.abs(_simulate_variants(rng, 300_000_000, cfg)[3])
    assert sizes.min() >= 50 and sizes.max() <= 6000
    # log-uniform: the geometric middle of the range splits the draws
    middle = np.sqrt(50 * 6001)
    assert 0.45 < np.mean(sizes < middle) < 0.55
