"""The trace reductions on a handmade Chrome trace, and the harness's clock
around the program's stages."""

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


def test_a_stage_missing_from_a_sample_fails_the_reading():
    import pytest

    from h100_bench.harness import Run
    from h100_bench.metrics import stage_mean

    run = Run(sample_stages=[{"ingest": 1.0}, {"ingest": 3.0}])
    assert stage_mean(run, "ingest") == 2.0
    with pytest.raises(RuntimeError):
        stage_mean(run, "snp_calling")
    with pytest.raises(RuntimeError):
        stage_mean(Run(), "ingest")
