"""What decides ``correct`` can fail: the control (the reference in the
program's place, one precision down) comes out not correct, and so does a
run of the harness whose timed path is broken underneath, once for each
fault a cell can have and under each entry; and the traffic's flags reach
the reference."""

import dataclasses
import json
import os

import numpy as np
import pytest

from conftest import BENCH, simulate, small_config
from h100_bench import compare, harness
from h100_bench.reference.control import CONTROL
from h100_bench.reference.pipeline import RunFlags, run_reference

CELLS = {"q20-20x.auto": "synth-ont-q20-20x",
         "q10-10x.auto": "synth-ont-q10-10x"}


def over(checks: dict) -> list[str]:
    return [k for k, c in checks.items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(tmp_path, small_data, cell):
    c = harness.load_cell(cell)
    checks = compare.control_checks(small_data[CELLS[cell]], str(tmp_path),
                                     c.traffic["pipeline"], c.limits, CONTROL)
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


def with_traffic(cell: harness.Cell, entry: str | None = None,
                 **flags) -> harness.Cell:
    """`cell` under its traffic with `entry` and the pipeline's `flags`
    set."""
    traffic = {**cell.traffic,
               "pipeline": {**cell.traffic["pipeline"], **flags}}
    if entry is not None:
        traffic["entry"] = entry
    return dataclasses.replace(cell, traffic=traffic)


@pytest.mark.parametrize("entry", sorted(harness.ENTRIES))
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_harness_run_with_a_broken_timed_path(tmp_path, monkeypatch, cell,
                                              fault, entry):
    c = with_traffic(harness.load_cell(cell), entry)
    c.config_path = small_config(CELLS[cell], str(tmp_path))
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    result = harness.run_cell(c, 977, 0.5, traced=False, device="cpu",
                              work_root=str(tmp_path))
    assert result["attempted"] >= 1
    assert result["correct"] == (fault == "none"), result["checks"]
    assert np.isfinite([m["value"] for m in result["metrics"].values()]).all()


# hotspots of slippage insertions, each of its own length, close enough to
# one another that the gap linkage (cutesv) and the span linkage (svim)
# cluster them differently
SVIM_DATA = {"contigs": {"chr21": 150_000}, "artifact_hotspots": 100,
             "artifact_hotspot_carry": 0.5, "artifact_len_max": 3000}
SVIM_SEED = 977


def svim_config(out_dir: str) -> str:
    with open(os.path.join(BENCH, "configs", "synth-ont-q20-20x.json")) as f:
        cfg = json.load(f)
    cfg["sim"].update(SVIM_DATA)
    path = os.path.join(out_dir, "svim-data.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def sv_calls(vcf: str) -> set:
    """(contig, pos, SVTYPE, SVLEN, support, GT) of each record."""
    out = set()
    with open(vcf) as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            info = dict(kv.split("=", 1) for kv in cols[7].split(";")
                        if "=" in kv)
            out.add((cols[0], int(cols[1]), info["SVTYPE"], info["SVLEN"],
                     info.get("RE", info.get("SUPPORT")),
                     cols[9].split(":")[0]))
    return out


def test_svim_and_cutesv_call_differently_on_the_data(tmp_path):
    data = simulate(svim_config(str(tmp_path)), SVIM_SEED,
                    str(tmp_path / "data"))
    bam, fa = os.path.join(data, "reads.bam"), os.path.join(data, "ref.fa")
    calls = {}
    for caller in ("cutesv", "svim"):
        ref = run_reference(bam, fa, str(tmp_path / caller),
                            RunFlags(sv_caller=caller))
        calls[caller] = sv_calls(os.path.join(ref.out_dir, "sv_calling",
                                              "variants.vcf"))
    assert calls["cutesv"] and calls["svim"]
    assert calls["cutesv"] - calls["svim"] and \
        calls["svim"] - calls["cutesv"]


@pytest.mark.parametrize("reference", ["traffic_flags", "default_flags"])
def test_the_traffics_flags_reach_the_reference(tmp_path, monkeypatch,
                                                reference):
    """Under ``sv_caller: svim`` a run is correct against a reference run
    with svim, and not correct against one run with the default flags (as
    the reference was run before it took the traffic's flags)."""
    c = with_traffic(harness.load_cell("q20-20x.auto"), sv_caller="svim")
    c.config_path = svim_config(str(tmp_path))
    if reference == "default_flags":
        monkeypatch.setattr(compare, "reference_flags",
                            lambda pipeline: RunFlags(
                                snp_model=pipeline["snp_model"]))
    result = harness.run_cell(c, SVIM_SEED, 0.5, traced=False, device="cpu",
                              work_root=str(tmp_path))
    assert result["attempted"] >= 1
    assert result["correct"] == (reference == "traffic_flags"), \
        result["checks"]
    assert (result["checks"]["sv_calling_lines"]["value"] > 0) == \
        (reference == "default_flags")
