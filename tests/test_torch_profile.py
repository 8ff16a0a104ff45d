"""`duet-tpu-torch --profile` on the CPU: the run is recorded with
torch.profiler into OUTPUT/profile/trace.json (a Chrome trace with
`traceEvents`) beside idle_by_span.json, and its artifacts are
byte-identical to the same run without the flag."""

import json
import os

import pytest

from duet_tpu_torch.cli import main as cli_main
from test_torch_modes import artifact_tree


def test_profile_writes_trace_and_same_artifacts(sim_dataset, tmp_path):
    data = sim_dataset[0]
    args = [os.path.join(data, "reads.bam"), os.path.join(data, "ref.fa")]
    common = ["--device", "cpu", "--device-stages", "on", "-t", "2"]
    plain, profiled = str(tmp_path / "plain"), str(tmp_path / "profiled")
    assert cli_main([*args, plain, *common]) == 0
    assert cli_main([*args, profiled, *common, "--profile"]) == 0
    assert artifact_tree(profiled) == artifact_tree(plain)
    assert sorted(os.listdir(os.path.join(profiled, "profile"))) == \
        ["idle_by_span.json", "trace.json"]
    with open(os.path.join(profiled, "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # torch ops of the device routes ran under the profiler
    assert any(n.startswith("aten::") for n in names)
    assert not os.path.exists(os.path.join(plain, "profile"))


def test_profile_trace_per_process(sim_dataset, tmp_path):
    """Two emulated processes under --profile: one trace and one idle
    split each, named as the logs are (trace.json on process 0,
    trace.p1.json on process 1)."""
    data = sim_dataset[0]
    args = [os.path.join(data, "reads.bam"), os.path.join(data, "ref.fa")]
    common = ["--device", "cpu", "--device-stages", "on", "-t", "2"]
    single, shared = str(tmp_path / "single"), str(tmp_path / "shared")
    assert cli_main([*args, single, *common]) == 0
    for pid in ("1", "0"):
        assert cli_main([*args, shared, *common, "--profile",
                         "--num-processes", "2", "--process-id", pid]) == 0
    assert sorted(os.listdir(os.path.join(shared, "profile"))) == \
        ["idle_by_span.json", "idle_by_span.p1.json", "trace.json",
         "trace.p1.json"]
    assert artifact_tree(shared) == artifact_tree(single)


def test_profile_trace_written_when_the_run_raises(sim_dataset, tmp_path):
    """As JAX's trace context, the trace is written when the run raises
    (here: --num-processes 2 without --process-id)."""
    data = sim_dataset[0]
    out = str(tmp_path / "out")
    with pytest.raises(ValueError, match="requires --process-id"):
        cli_main([os.path.join(data, "reads.bam"),
                  os.path.join(data, "ref.fa"), out, "--device", "cpu",
                  "--num-processes", "2", "--profile"])
    with open(os.path.join(out, "profile", "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_profile_export_failure_keeps_the_runs_error(sim_dataset, tmp_path,
                                                     monkeypatch, capsys):
    """When the run raises and the trace export fails too, the run's own
    error is the one raised; the export's is reported on stderr."""
    import torch.profiler

    def fail(self, path):
        raise OSError("disk full")

    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace", fail)
    data = sim_dataset[0]
    with pytest.raises(ValueError, match="requires --process-id"):
        cli_main([os.path.join(data, "reads.bam"),
                  os.path.join(data, "ref.fa"), str(tmp_path / "out"),
                  "--device", "cpu", "--num-processes", "2", "--profile"])
    assert "profile trace not written: disk full" in capsys.readouterr().err
