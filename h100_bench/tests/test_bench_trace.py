"""The trace reductions on a handmade Chrome trace, and the harness's clock
around the program's stages under each entry."""

import dataclasses

import pytest

from h100_bench.trace import device_busy, device_ops, idle_by_stage


def event(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}


EVENTS = [
    event("user_annotation", "stage:ingest", 0, 40),
    event("user_annotation", "stage:snp_phasing", 50, 50),
    event("cpu_op", "aten::add", 0, 100),
    event("kernel", "k1", 60, 10),
    event("kernel", "k2", 65, 10),       # overlaps k1: counted once
    event("gpu_memcpy", "Memcpy HtoD", 80, 5),
    event("gpu_memset", "Memset", 84, 2),
    event("ac2g", "flow", 10, 0),
]


def test_device_busy_is_the_union_over_the_window():
    busy, window = device_busy(EVENTS)
    assert busy == 15 + 6          # [60, 75) and [80, 86)
    assert window == 100


def test_idle_time_by_stage_and_device_ops():
    idle = dict(idle_by_stage(EVENTS))
    assert idle == {"ingest": 40e-6, "snp_phasing": 29e-6,
                    "outside stages": 10e-6}
    assert device_ops(EVENTS)[0] == ["k1", 10e-6]
    assert {n for n, _ in device_ops(EVENTS)} == \
        {"k1", "k2", "Memcpy HtoD", "Memset"}


def test_stage_clock_times_each_stage_and_restores_the_program(
        tmp_path, small_data):
    from duet_tpu_torch import pipeline

    from h100_bench import clock, harness

    stages, ingest = pipeline.STAGES, pipeline._ingest
    cell = harness.load_cell("q20-20x.auto")
    peaks = {}
    wall, metrics, timed = harness.sample(
        cell, small_data["synth-ont-q20-20x"], str(tmp_path / "out"), "cpu",
        peaks)
    assert pipeline.STAGES is stages and pipeline._ingest is ingest
    want = {"ingest"} | {clock.stage_key(n) for n, _ in stages}
    assert set(timed) == want == {"ingest", "snp_calling", "sv_calling",
                                  "snp_phasing", "sv_phasing"}
    assert 0 < sum(timed.values()) <= wall
    assert set(peaks) == want
    assert 0 < peaks["ingest"] <= peaks["snp_calling"] <= clock.peak_mb()
    assert metrics["backends"]


def stream_names():
    """Every name the stream clock wraps, with what it holds now."""
    from duet_tpu_torch import pipeline
    from duet_tpu_torch.io import readstore
    from duet_tpu_torch.models import snp_caller

    from h100_bench import clock

    owners = [(readstore, "stream_contig_reads_auto"),
              (readstore, "prefetch_iter"), (pipeline, "FastaFile"),
              (snp_caller, "call_contig_snps")] + \
        [(pipeline, name) for name, _ in clock.STREAM_PIPELINE_NAMES]
    return {(o.__name__, n): getattr(o, n) for o, n in owners}


@pytest.mark.parametrize("prefetch", [True, False])
def test_stage_clock_times_a_stream_sample_contig_by_contig(
        tmp_path, small_data, monkeypatch, prefetch):
    """Under ``"entry": "stream"`` the clock times the same five keys,
    each summed over the contigs and inside the program's own span of that
    stage, and puts every wrapped name back."""
    import os

    from duet_tpu_torch import pipeline

    from h100_bench import clock, harness

    if not prefetch:   # the loop decodes ahead only with 4 cores or more
        monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0})
    before = stream_names()
    stages, ingest = pipeline.STAGES, pipeline._ingest
    cell = harness.load_cell("q20-20x.auto")
    cell = dataclasses.replace(cell, traffic={**cell.traffic,
                                              "entry": "stream"})
    peaks = {}
    wall, metrics, timed = harness.sample(
        cell, small_data["synth-ont-q20-20x"], str(tmp_path / "out"), "cpu",
        peaks)
    assert stream_names() == before
    assert pipeline.STAGES is stages and pipeline._ingest is ingest
    assert metrics["mode"] == "streaming" and metrics["counts"]["contigs"] == 2
    keys = {"ingest", "snp_calling", "sv_calling", "snp_phasing",
            "sv_phasing"}
    assert set(timed) == set(peaks) == keys
    assert 0 < sum(timed.values()) <= wall
    for key in keys:
        # the program's span of the stage holds the timed pieces, and
        # little else (its seconds are rounded to 0.1 ms)
        own = metrics["stages"][key]
        assert 0.5 * own < timed[key] <= own + 2e-4, (key, timed, own)
    assert 0 < max(peaks.values()) <= clock.peak_mb()


def test_a_stage_missing_from_a_sample_fails_the_reading():
    from h100_bench.harness import Run
    from h100_bench.metrics import stage_mean

    run = Run(sample_stages=[{"ingest": 1.0}, {"ingest": 3.0}])
    assert stage_mean(run, "ingest") == 2.0
    with pytest.raises(RuntimeError):
        stage_mean(run, "snp_calling")
    with pytest.raises(RuntimeError):
        stage_mean(Run(), "ingest")
