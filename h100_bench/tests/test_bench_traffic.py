"""A traffic's entry, flags and inputs: ``load_cell`` takes ``"entry":
"batch"`` or ``"stream"``, the flags the plain reference honours and a
count of inputs, and refuses the rest by name; the two cells load as they
did before traffic had an entry; a stream cell runs, is timed stage by
stage and is judged as a batch cell is; and a run takes its inputs in turn
and judges each."""

import dataclasses
import itertools
import json
import os
import types

import pytest

from conftest import small_config
from h100_bench import compare, harness
from h100_bench.reference.pipeline import RunFlags

MANIFEST = os.path.join(harness.ROOT, "BENCHMARK.json")
KEYS = {"ingest", "snp_calling", "sv_calling", "snp_phasing", "sv_phasing"}
AUTO = {"device_stages": "auto", "snp_model": "auto", "threads": 4}


def cell_with_traffic(tmp_path, monkeypatch, traffic: dict) -> harness.Cell:
    """load_cell on a manifest of one cell whose traffic is `traffic`."""
    bench = tmp_path / "h100_bench"
    for sub in ("traffic", "workloads"):
        (bench / sub).mkdir(parents=True)
    (bench / "traffic" / "t.json").write_text(json.dumps(traffic))
    (bench / "workloads" / "x.t.json").write_text(
        json.dumps({"limits": {}}))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "workloads": [{"name": "x.t", "config": "synth-ont-q20-20x",
                       "traffic": "t", "chips": 1, "why": "a test"}],
        "end_to_end": [], "per_layer": []}))
    monkeypatch.setattr(harness, "BENCH_DIR", str(bench))
    return harness.load_cell("x.t", root=str(tmp_path))


@pytest.mark.parametrize("traffic", [
    {"pipeline": AUTO},
    {"entry": "batch", "pipeline": AUTO},
    {"entry": "stream", "pipeline": AUTO},
    {"inputs": 4, "pipeline": AUTO},
    {"entry": "stream", "pipeline": {
        **AUTO, "use_device_kernel": False, "sv_caller": "svim",
        "cluster_max_distance": 0.5, "min_support_read": 3,
        "min_allele_frequency": 0.3, "sv_min_size": 60,
        "min_junction_evidence": 1.0, "adaptive_junction_split": False}},
])
def test_load_cell_takes_an_entry_and_the_flags_the_reference_honours(
        tmp_path, monkeypatch, traffic):
    assert cell_with_traffic(tmp_path, monkeypatch, traffic).traffic == \
        traffic


@pytest.mark.parametrize("traffic,named", [
    ({"entry": "replay", "pipeline": AUTO}, "replay"),
    ({"entry": "stream", "pipeline": {**AUTO, "haplotag_bam": True}},
     "haplotag_bam"),
    ({"pipeline": {**AUTO, "haplotag_bam": True}}, "haplotag_bam"),
    ({"pipeline": {**AUTO, "include_all_ctgs": True}}, "include_all_ctgs"),
    ({"pipeline": {**AUTO, "phase_bnd": True}}, "phase_bnd"),
    ({"pipeline": {**AUTO, "decision_model": "learned"}}, "decision_model"),
    ({"pipeline": {**AUTO, "num_processes": 2, "process_id": 0}},
     "num_processes, process_id"),
    ({"pipeline": {**AUTO, "mesh": "auto"}}, "mesh"),
])
def test_load_cell_refuses_what_the_reference_cannot_honour(
        tmp_path, monkeypatch, traffic, named):
    with pytest.raises(SystemExit, match=named):
        cell_with_traffic(tmp_path, monkeypatch, traffic)


@pytest.mark.parametrize("inputs", [0, -1, 2.5, "4", True])
def test_load_cell_refuses_inputs_that_are_not_a_count(tmp_path, monkeypatch,
                                                        inputs):
    with pytest.raises(SystemExit, match="inputs"):
        cell_with_traffic(tmp_path, monkeypatch,
                          {"inputs": inputs, "pipeline": AUTO})


def test_input_seeds_begin_with_the_runs_own_and_are_drawn_from_it():
    seed = 2**32 + 5
    seeds = harness.input_seeds(seed, 4)
    assert seeds[0] == seed and len(set(seeds)) == 4
    assert seeds == harness.input_seeds(seed, 4)
    assert harness.input_seeds(seed, 2) == seeds[:2]
    assert not set(harness.input_seeds(seed + 1, 4)[1:]) & set(seeds)
    assert harness.input_seeds(7, 1) == [7]


def test_every_flag_of_the_program_is_the_references_a_route_or_refused():
    """A flag the program adds has to be sorted into one of the three."""
    from duet_tpu_torch.pipeline import PipelineConfig

    fields = {f.name: None for f in dataclasses.fields(PipelineConfig)}
    assert set(compare.FLAGS) | set(compare.ROUTE_ONLY) <= set(fields)
    assert set(compare.unhonoured(fields)) == {
        "bam", "reference", "output", "device", "resume", "include_all_ctgs",
        "haplotag_bam", "phase_bnd", "decision_model", "mesh",
        "num_processes", "process_id", "coordinator"}


def test_reference_flags_take_every_flag_of_the_traffic():
    assert compare.reference_flags(AUTO) == RunFlags()
    assert compare.reference_flags(
        {**AUTO, "threads": 8, "sv_caller": "svim", "min_support_read": 3,
         "snp_model": "counts"}) == \
        RunFlags(sv_caller="svim", min_support_read=3, snp_model="counts")


def manifest() -> dict:
    with open(MANIFEST) as f:
        return json.load(f)


@pytest.mark.parametrize("name", [w["name"] for w in manifest()["workloads"]])
def test_the_cells_load_as_before_traffic_had_an_entry(name):
    """The Cell that load_cell made before, from the files as they are."""
    m = manifest()
    entry = next(w for w in m["workloads"] if w["name"] == name)

    def read(*parts):
        with open(os.path.join(harness.BENCH_DIR, *parts)) as f:
            return json.load(f)

    def applies(metric):
        return name in metric.get("workloads", [name])

    want = harness.Cell(
        name=name, chips=entry["chips"],
        config_path=os.path.join(harness.BENCH_DIR, "configs",
                                 entry["config"] + ".json"),
        traffic=read("traffic", entry["traffic"] + ".json"),
        limits=read("workloads", name + ".json")["limits"],
        end_to_end=[x["name"] for x in m["end_to_end"] if applies(x)],
        per_layer=[x["name"] for x in m["per_layer"] if applies(x)])
    got = harness.load_cell(name)
    assert got == want
    assert "entry" not in got.traffic
    assert compare.reference_flags(got.traffic["pipeline"]) == \
        RunFlags(snp_model=got.traffic["pipeline"]["snp_model"])


def test_a_stream_cell_runs_is_timed_and_judged(tmp_path, monkeypatch):
    """A stream run through run_cell: correct, all five stage keys in
    every sample, each key's range in the trace, and the artifacts of a
    batch sample on the same input."""
    cell = harness.load_cell("q20-20x.auto")
    cell.config_path = small_config("synth-ont-q20-20x", str(tmp_path))
    stream = dataclasses.replace(cell, traffic={**cell.traffic,
                                                "entry": "stream"})
    real = harness.sample
    seen, batch = [], []

    def spy(c, data, out, device, peaks=None):
        got = real(c, data, out, device, peaks)
        seen.append((got[2], harness.artifact_digest(out)))
        if not batch:
            real(cell, data, out + "-batch", device)
            batch.append(harness.artifact_digest(out + "-batch"))
        return got

    monkeypatch.setattr(harness, "sample", spy)
    result = harness.run_cell(stream, 20261018, 0.5, traced=True,
                              device="cpu", work_root=str(tmp_path))
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    # cold, warm-up, the window's, the traced
    assert len(seen) == 2 + result["attempted"] + harness.TRACED_SAMPLES
    assert all(set(stages) == KEYS for stages, _ in seen)
    assert {digest for _, digest in seen} == set(batch)
    assert KEYS <= {name for name, _ in result["breakdown"]["idle_gaps"]}


@pytest.mark.parametrize("fault_on", ["none", "data1"])
def test_a_run_takes_its_inputs_in_turn_and_judges_each(tmp_path, monkeypatch,
                                                        fault_on):
    """Two inputs: a warm-up on the second, the window's samples in turn,
    and each input's first sample judged, so that answers altered on the
    second input alone make the run not correct."""
    import duet_tpu_torch.models.snp_caller as m

    cell = harness.load_cell("q10-10x.auto")
    cell.config_path = small_config("synth-ont-q10-10x", str(tmp_path))
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "inputs": 2})
    real_call, real_sample = m.call_snps_any, harness.sample
    seen = []

    def altered(*args, **kw):
        snps = real_call(*args, **kw)
        if seen[-1] == fault_on and len(snps.is_het):
            snps.is_het = snps.is_het.copy()
            snps.is_het[len(snps.is_het) // 2] ^= True
        return snps

    def spy(c, data, out, device, peaks=None):
        seen.append(os.path.basename(data))
        return real_sample(c, data, out, device, peaks)

    # a clock that steps a tenth of a second a reading: a few samples a
    # window, whatever the host's speed
    ticks = itertools.count()
    monkeypatch.setattr(harness, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks) / 10))
    monkeypatch.setattr(m, "call_snps_any", altered)
    monkeypatch.setattr(harness, "sample", spy)
    result = harness.run_cell(cell, 2**31 + 3, 1.0, traced=False,
                              device="cpu", work_root=str(tmp_path))
    n = result["attempted"]
    assert n >= 3
    window = [("data", "data1")[k % 2] for k in range(n)]
    assert seen == ["data", "data1"] + window
    assert result["correct"] == (fault_on == "none"), result["checks"]
    assert result["failed"] == window.count(fault_on)
    assert result["checks"]["samples_unlike_first"]["value"] == 0
