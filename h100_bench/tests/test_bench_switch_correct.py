"""The reader of ``switch_correct_s`` on a handmade Run: the window mean,
nothing to read from a program whose samples lack the span (the registry
with it or without), a fault where only some samples have it; and on one
sample of the program on the CPU, inside the refine's span."""

import pytest

from h100_bench.harness import Run, read_metrics
from h100_bench.metrics import switch_correct_s


def sample(k: float, with_span: bool = True) -> dict:
    def s(x):
        return {"s": x * k, "self_s": x * k, "n": 1, "max_s": x * k,
                "parent": None}

    spans = {"snp_phasing.refine": s(1.0)}
    if with_span:
        spans["snp_phasing.switch_correct"] = s(0.04)
    return {"spans": spans, "counters": {}}


def test_the_window_mean():
    run = Run(sample_metrics=[sample(1.0), sample(2.0)])
    assert switch_correct_s.UNIT == "s"
    assert switch_correct_s.read(run) == pytest.approx(0.04 * 1.5)


@pytest.mark.parametrize("samples", [
    [sample(1.0, False), sample(2.0, False)],          # registry, no span
    [{"stages": {"ingest": 0.4}, "backends": {}}] * 2,  # no registry
])
def test_a_program_without_the_span_leaves_the_metric_out(samples):
    run = Run(sample_metrics=samples)
    assert switch_correct_s.read(run) is None
    assert read_metrics(["switch_correct_s"], run) == {}


@pytest.mark.parametrize("samples", [
    [sample(1.0), sample(2.0, False)],
    [sample(1.0, False), sample(2.0)],
    [],
])
def test_some_samples_without_the_span_fail_the_reading(samples):
    with pytest.raises(RuntimeError):
        switch_correct_s.read(Run(sample_metrics=samples))


def test_the_reader_on_a_run_of_the_program(tmp_path, small_data):
    from h100_bench import harness

    cell = harness.load_cell("q10-10x.auto")
    assert "switch_correct_s" in cell.per_layer
    _, metrics, _ = harness.sample(
        cell, small_data["synth-ont-q10-10x"], str(tmp_path / "out"), "cpu")
    got = read_metrics(["switch_correct_s", "phase_refine_s"],
                       Run(sample_metrics=[metrics]))
    assert 0 < got["switch_correct_s"]["value"] \
        <= got["phase_refine_s"]["value"]
