"""The readers of the program's spans and counters on a handmade Run: each
mean, a fault where a sample lacks the name, nothing where the program has
no registry, and ``artifact_write_s`` without the tabix index."""

import importlib

import pytest

from h100_bench.harness import Run, read_metrics

NEW = ("snp_features_s", "snp_network_s", "phase_refine_s",
       "artifact_write_s", "ingest_inflate_s")


def sample(k: float) -> dict:
    """A window sample's metrics.json with the registry, scaled by k."""
    def s(x):
        return {"s": x * k, "self_s": x * k, "n": 1, "max_s": x * k,
                "parent": None}

    return {
        "spans": {"snp_calling": s(3.0), "snp_calling.features": s(2.0),
                  "snp_calling.network": s(0.1),
                  "snp_phasing.refine": s(1.0),
                  "write.pileup_vcf": s(0.7), "write.phased_snp_vcf": s(0.6),
                  "write.sv_vcf": s(0.05), "index.tabix": s(1.0)},
        "counters": {"ingest.inflate_s": 0.25 * k,
                     "ingest.bytes_inflated": 10},
    }


def run_of(*samples) -> Run:
    return Run(sample_metrics=list(samples))


@pytest.mark.parametrize("name,want", [
    ("snp_features_s", 2.0 * 1.5),
    ("snp_network_s", 0.1 * 1.5),
    ("phase_refine_s", 1.0 * 1.5),
    ("artifact_write_s", (0.7 + 0.6 + 0.05) * 1.5),   # no index.tabix
    ("ingest_inflate_s", 0.25 * 1.5),
])
def test_each_reader_is_the_window_mean(name, want):
    run = run_of(sample(1.0), sample(2.0))
    mod = importlib.import_module(f"h100_bench.metrics.{name}")
    assert mod.UNIT == "s"
    assert mod.read(run) == pytest.approx(want)


@pytest.mark.parametrize("name,drop", [
    ("snp_features_s", ("spans", "snp_calling.features")),
    ("snp_network_s", ("spans", "snp_calling.network")),
    ("phase_refine_s", ("spans", "snp_phasing.refine")),
    ("ingest_inflate_s", ("counters", "ingest.inflate_s")),
])
def test_a_sample_without_the_name_fails_the_reading(name, drop):
    section, key = drop
    short = sample(1.0)
    del short[section][key]
    mod = importlib.import_module(f"h100_bench.metrics.{name}")
    with pytest.raises(RuntimeError):
        mod.read(run_of(sample(1.0), short))
    with pytest.raises(RuntimeError):
        mod.read(run_of())


def test_artifact_write_s_needs_a_writer_in_every_sample():
    from h100_bench.metrics import artifact_write_s

    short = sample(1.0)
    short["spans"] = {n: e for n, e in short["spans"].items()
                      if not n.startswith("write.")}
    with pytest.raises(RuntimeError):
        artifact_write_s.read(run_of(sample(1.0), short))


def test_a_program_without_the_registry_leaves_the_metrics_out():
    """The parent program writes no spans or counters: each reader finds
    nothing to read, and the result line leaves the metric out."""
    old = {"stages": {"ingest": 0.4}, "backends": {}}
    run = run_of(old, dict(old))
    assert read_metrics(list(NEW), run) == {}
    mixed = run_of(sample(1.0), old)
    for name in NEW:
        mod = importlib.import_module(f"h100_bench.metrics.{name}")
        with pytest.raises(RuntimeError):
            mod.read(mixed)


def test_the_readers_on_a_run_of_the_program(tmp_path, small_data):
    """One sample of the program on the CPU: its metrics.json has every
    name the readers read, each inside its stage."""
    from h100_bench import harness

    cell = harness.load_cell("q10-10x.auto")
    assert set(NEW) <= set(cell.per_layer)
    cell.traffic = {"pipeline": {**cell.traffic["pipeline"],
                                 "snp_model": "nn"}}
    wall, metrics, stages = harness.sample(
        cell, small_data["synth-ont-q10-10x"], str(tmp_path / "out"), "cpu")
    got = read_metrics(list(NEW), run_of(metrics))
    assert set(got) == set(NEW)
    v = {n: got[n]["value"] for n in NEW}
    assert 0 < v["snp_features_s"] + v["snp_network_s"] <= \
        stages["snp_calling"]
    assert 0 < v["phase_refine_s"] <= stages["snp_phasing"]
    assert 0 < v["ingest_inflate_s"] <= stages["ingest"]
    assert 0 < v["artifact_write_s"] <= sum(stages.values())
