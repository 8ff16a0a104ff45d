"""The port's span registry (``utils.spans``) on the CPU: nesting and self
time, threads, reset, the profiler ranges it opens only while a profiler
records, the spans and counters a run writes into metrics.json, the
``devcost`` and ``dispatch`` views over it, and ``idle_by_span``'s split
of a trace's idle time on a handmade event list."""

import json
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

from duet_tpu_torch.cli import main as cli_main
from duet_tpu_torch.pipeline import (
    STAGE_KEYS,
    PipelineConfig,
    run_pipeline,
    run_pipeline_streaming,
)
from duet_tpu_torch.utils import devcost, dispatch, spans
from duet_tpu_torch.utils.spans import OUTSIDE, idle_by_span, span

CPU = torch.device("cpu")
NATIVE_KEYS = ["fread_s", "inflate_s", "scan_s", "size_s", "fill_s",
               "bytes_compressed", "bytes_inflated", "bgzf_members",
               "inflate_batches", "minor_faults", "major_faults",
               "cpu_user_s", "cpu_kernel_s", "py_fetch_s"]
# every run's spans, and each SNP route's own
COMMON = {"ingest", "ingest.fasta_index", "ingest.bam_decode",
          "snp_calling", "sv_calling", "snp_phasing", "sv_phasing",
          "snp_calling.counts", "snp_calling.at_site",
          "sv_calling.contigs", "sv_calling.bnds",
          "snp_phasing.refine", "snp_phasing.switch_correct",
          "snp_phasing.score", "snp_phasing.read_haps",
          "sv_phasing.parse", "sv_phasing.decide",
          "write.pileup_vcf", "write.sv_vcf", "write.phased_snp_vcf",
          "write.haplotag_table", "write.phased_sv_vcf", "index.tabix"}
NN = {"snp_calling.features", "snp_calling.network"}
COUNTING = {"snp_calling.count_rule"}


@pytest.fixture
def fake_clock(monkeypatch):
    """The registry's clock reads 0, 1, 2, ... seconds, one a read."""
    ticks = iter(range(10_000))
    monkeypatch.setattr(spans, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(ticks))))
    spans.reset()
    yield
    spans.reset()


def test_nesting_and_self_time(fake_clock):
    with span("a"):                         # enters at 0
        with span("a.b"):                   # 1 .. 2
            pass
        with span("a.c") as c:              # 3 .. 6
            with span("a.c.d"):             # 4 .. 5
                pass
    snap = spans.snapshot()["spans"]         # a leaves at 7
    assert c.s == 3.0
    assert snap["a"] == {"s": 7.0, "self_s": 3.0, "n": 1, "max_s": 7.0,
                         "parent": None}
    assert snap["a.b"] == {"s": 1.0, "self_s": 1.0, "n": 1, "max_s": 1.0,
                           "parent": "a"}
    assert snap["a.c"]["self_s"] == 2.0 and snap["a.c"]["parent"] == "a"
    assert snap["a.c.d"]["parent"] == "a.c"


def test_a_name_adds_its_calls_and_keeps_its_longest(fake_clock):
    for _ in range(3):
        with span("x"):
            pass
    with span("x"):
        with span("y"):
            pass
    e = spans.snapshot()["spans"]["x"]
    assert (e["s"], e["n"], e["max_s"], e["self_s"]) == (6.0, 4, 3.0, 5.0)


def test_span_as_a_decorator(fake_clock):
    @span("write.thing")
    def write(x):
        """Doc."""
        return x + 1

    assert write(1) == 2 and write(2) == 3
    assert write.__doc__ == "Doc." and write.__name__ == "write"
    assert spans.snapshot()["spans"]["write.thing"]["n"] == 2


def test_a_raising_block_still_closes_its_span():
    spans.reset()
    with pytest.raises(ValueError):
        with span("outer"):
            with span("inner"):
                raise ValueError("x")
    with span("after"):
        pass
    snap = spans.snapshot()["spans"]
    assert snap["inner"]["parent"] == "outer"
    assert snap["after"]["parent"] is None


def test_threads_sum_their_seconds_and_lose_no_update():
    """More threads than cores, a short switch interval: every call and
    every count lands; a span opened on a worker thread has no parent,
    and one name's seconds are summed over the threads."""
    spans.reset()
    n_threads, n_calls = 4 * (os.cpu_count() or 1), 200
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_calls):
                with span("pool.work"):
                    with span("pool.work.inner"):
                        spans.count("pool.items", 2)

        with span("pool"):
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    snap = spans.snapshot()
    work_, inner = snap["spans"]["pool.work"], snap["spans"]["pool.work.inner"]
    assert work_["n"] == inner["n"] == n_threads * n_calls
    assert work_["parent"] is None and inner["parent"] == "pool.work"
    assert snap["counters"]["pool.items"] == 2 * n_threads * n_calls
    assert 0 <= work_["self_s"] <= work_["s"]
    assert snap["spans"]["pool"]["self_s"] == snap["spans"]["pool"]["s"]


def test_reset_by_prefix():
    spans.reset()
    with span("device.x.h2d"):
        pass
    with span("ingest"):
        pass
    spans.count("device.x.h2d_bytes", 5)
    spans.count("dispatch.x.host")
    spans.reset("device.")
    snap = spans.snapshot()
    assert set(snap["spans"]) == {"ingest"}
    assert snap["counters"] == {"dispatch.x.host": 1}
    assert spans.snapshot("dispatch.")["spans"] == {}
    spans.reset()
    assert spans.snapshot() == {"spans": {}, "counters": {}}


def test_no_profiler_range_unless_a_profiler_records(monkeypatch):
    """Off, a span enters no record_function; under torch.profiler it
    enters one of its own name."""
    import torch.autograd.profiler as autograd_profiler

    entered = []
    real = autograd_profiler.record_function

    class Spy(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(autograd_profiler, "record_function", Spy)
    with span("off.one"):
        pass
    assert entered == []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with span("on.one"):
            pass
    assert entered == ["on.one"]


def test_stage_timer_logs_its_banners_and_opens_the_stage_span(caplog):
    import logging

    from duet_tpu_torch.utils.logging import StageTimer, get_logger

    spans.reset()
    get_logger().propagate = True
    try:
        with caplog.at_level(logging.INFO, logger="duet_tpu"):
            with StageTimer("SNP CALLING") as s:
                pass
    finally:
        get_logger().propagate = False
    lines = [r.getMessage() for r in caplog.records]
    assert lines == ["*" * 25 + " SNP CALLING STARTED " + "*" * 25,
                     "*" * 25 + f" SNP CALLING COMPLETED IN {round(s.s, 3)}s "
                     + "*" * 25]
    assert spans.snapshot()["spans"]["snp_calling"]["n"] == 1


def test_devcost_and_dispatch_keep_their_schemas():
    spans.reset()
    a, b = np.arange(10, dtype=np.int32), np.ones((3, 4), np.float64)
    da, db = devcost.put("haplotag", CPU, a, b)
    out = devcost.run("haplotag", CPU, lambda: da.sum() + db.sum())
    devcost.get("haplotag", out.reshape(1))
    devcost.run("haplotag", CPU, lambda: da)
    dispatch.record("haplotag", "device")
    dispatch.record("haplotag", "host", 2)
    dispatch.record("sv_decide", "host", 0)
    cost = devcost.snapshot()
    assert list(cost) == ["haplotag"]
    row = cost["haplotag"]
    assert tuple(row) == devcost._FIELDS
    assert row["h2d_bytes"] == 40 + 96 and row["n_puts"] == 2
    assert row["n_dispatch"] == 2 and row["d2h_bytes"] == 8
    assert all(isinstance(row[k], int)
               for k in ("h2d_bytes", "n_puts", "n_dispatch", "d2h_bytes"))
    assert 0 <= row["worst_put_s"] <= row["h2d_s"]
    assert dispatch.snapshot() == {"haplotag": {"device": 1, "host": 2},
                                   "sv_decide": {"host": 0}}
    assert dispatch.backend_label("haplotag") == "device+host"
    assert dispatch.backend_label("sv_decide") == "unused"
    # each view resets its own names only
    dispatch.reset()
    assert dispatch.snapshot() == {} and devcost.snapshot() == cost
    devcost.reset()
    assert devcost.snapshot() == {}


def _paths(data):
    return dict(bam=os.path.join(data, "reads.bam"),
                reference=os.path.join(data, "ref.fa"))


# a value rounded to 4 places against the same value rounded to 6: the two
# roundings' half-units, and float epsilon
ROUNDINGS = 5e-5 + 5e-7


def _same_seconds(at_4: float, at_6: float) -> bool:
    """Whether `at_4` and `at_6` can be one value rounded to 4 and to 6
    places (a stage's seconds, and its span's in metrics.json)."""
    return abs(at_4 - at_6) <= ROUNDINGS + 1e-12


@pytest.mark.parametrize("x", [0.12344951, 0.0350500001, 0.0351, 2.71828])
def test_same_seconds_holds_across_a_rounding_edge(x):
    """Rounded to 6 places and then to 4, a value on a rounding edge can
    land a unit away from it rounded once to 4; the two still agree."""
    assert _same_seconds(round(x, 4), round(x, 6))
    assert not _same_seconds(round(x, 4) + 2 * ROUNDINGS, round(x, 6))


def _check_registry(m: dict, expected: set) -> None:
    """metrics.json's spans, counters, stages and ingest.native agree."""
    got = m["spans"]
    assert expected <= set(got), expected - set(got)
    assert not [n for n in got if n.startswith("stage:")]
    for k in STAGE_KEYS:
        assert got[k]["parent"] in (None, "streaming_contig_pass"), k
        assert _same_seconds(m["stages"][k], got[k]["s"]), k
    for name, e in got.items():
        assert e["n"] >= 1 and 0 <= e["max_s"] <= e["s"] + 1e-6, name
        assert e["self_s"] <= e["s"] + 1e-6, name
    assert got["index.tabix"]["parent"].startswith("write.")
    # pileup.vcf.gz and the one contig's phased VCF, each indexed once and
    # from its writer's offsets: a re-read would index a third time
    assert m["counters"]["index.tabix.from_writer"] == 2
    assert got["index.tabix"]["n"] == 2
    native = m["ingest"]["native"]
    assert list(native) == NATIVE_KEYS
    c = m["counters"]
    assert native["bytes_inflated"] == c["ingest.bytes_inflated"] > 0
    assert _same_seconds(native["inflate_s"], c["ingest.inflate_s"])
    assert c["snp_phasing.correct_rounds"] >= 1
    assert c["snp_phasing.switch_flips"] >= 0
    assert c["snp_phasing.switch_correct_fallbacks"] == 0
    assert m["device_dispatch"] == {
        stage: {backend: c[f"dispatch.{stage}.{backend}"] for backend in row}
        for stage, row in m["device_dispatch"].items()}
    assert m["device_dispatch"]["snp_pileup"]


# each span's parent in a batch run of the counting rule, and where a
# streamed run's differ: its contig pass holds the per-contig stages, and
# the pileup and SV VCFs are written after it, outside every stage
PARENTS = {
    "ingest": None, "ingest.fasta_index": "ingest",
    "ingest.bam_decode": "ingest",
    "snp_calling": None, "snp_calling.counts": "snp_calling",
    "snp_calling.count_rule": "snp_calling",
    "snp_calling.at_site": "snp_calling",
    "write.pileup_vcf": "snp_calling", "index.tabix": "write.pileup_vcf",
    "sv_calling": None, "sv_calling.contigs": "sv_calling",
    "sv_calling.bnds": "sv_calling", "write.sv_vcf": "sv_calling",
    "snp_phasing": None, "snp_phasing.refine": "snp_phasing",
    "snp_phasing.switch_correct": "snp_phasing.refine",
    "snp_phasing.score": "snp_phasing",
    "snp_phasing.read_haps": "snp_phasing",
    "write.phased_snp_vcf": "snp_phasing",
    "write.haplotag_table": "snp_phasing",
    "sv_phasing": None, "sv_phasing.parse": "sv_phasing",
    "sv_phasing.decide": "sv_phasing", "write.phased_sv_vcf": "sv_phasing",
}
STREAM_PARENTS = {
    **{k: v for k, v in PARENTS.items() if k not in
       ("ingest.fasta_index", "ingest.bam_decode")},
    "streaming_contig_pass": None,
    "ingest": "streaming_contig_pass",
    "snp_calling": "streaming_contig_pass",
    "sv_calling": "streaming_contig_pass",
    "snp_phasing": "streaming_contig_pass",
    "write.pileup_vcf": None, "write.sv_vcf": None, "sv_calling.bnds": None,
    "index.tabix": "write.phased_snp_vcf",
}
# metrics.json's blocks in every run, and each entry's own keys
METRICS_COMMON = {"ingest", "counts", "backends", "device_dispatch",
                  "device_cost", "device", "device_size_gates", "stages",
                  "total_s", "peak_rss_mb", "spans", "counters"}
METRICS_OWN = {"batch": {"ingest_reads_per_s"},
               "stream": {"mode", "ingest_backend", "stage_peak_rss_mb",
                          "reads_per_s"}}
COUNTS_OWN = {"batch": set(), "stream": {"sv_candidates"}}


@pytest.mark.parametrize("mode", ["batch", "stream"])
def test_run_writes_its_spans_and_counters(sim_dataset, tmp_path, mode):
    out = str(tmp_path / mode)
    cfg = PipelineConfig(output=out, device="cpu", snp_model="counts",
                         **_paths(sim_dataset[0]))
    (run_pipeline if mode == "batch" else run_pipeline_streaming)(cfg)
    with open(os.path.join(out, "metrics.json")) as f:
        m = json.load(f)
    assert m["ingest"]["backend"] == "native"
    _check_registry(m, COMMON - {"ingest.fasta_index", "ingest.bam_decode"}
                    | COUNTING)
    assert {name: e["parent"] for name, e in m["spans"].items()} == \
        (PARENTS if mode == "batch" else STREAM_PARENTS)
    assert set(m) == METRICS_COMMON | METRICS_OWN[mode]
    assert set(m["counts"]) == {"reads", "contigs", "snp_sites",
                                "tagged_reads"} | COUNTS_OWN[mode]
    if mode == "batch":
        assert m["spans"]["ingest.bam_decode"]["parent"] == "ingest"
        assert _same_seconds(m["ingest"]["bam_decode_s"],
                             m["spans"]["ingest.bam_decode"]["s"])
    else:
        # the streaming pass holds the per-contig stage spans
        assert m["spans"]["streaming_contig_pass"]["parent"] is None
        assert m["spans"]["snp_calling"]["n"] == m["counts"]["contigs"]


@pytest.mark.parametrize("snp_model,stages,own", [
    ("nn", "on", NN),
    ("counts", "off", COUNTING),
    ("auto", "off", {"snp_calling.model_choice"}),
])
def test_profiled_run_shows_every_span_as_a_range(sim_dataset, tmp_path,
                                                  snp_model, stages, own):
    """Under --profile every span of the run is a ``user_annotation``
    range of its name, as many as its calls, and idle_by_span.json splits
    the trace's idle time among them exactly."""
    data = sim_dataset[0]
    out = str(tmp_path / "out")
    assert cli_main([os.path.join(data, "reads.bam"),
                     os.path.join(data, "ref.fa"), out, "--device", "cpu",
                     "--device-stages", stages, "--snp-model", snp_model,
                     "-t", "2", "--profile"]) == 0
    with open(os.path.join(out, "metrics.json")) as f:
        m = json.load(f)
    _check_registry(m, COMMON | own)
    with open(os.path.join(out, "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    for name, e in m["spans"].items():
        assert ranges.count(name) == e["n"], name
    if stages == "on":
        assert {"device.haplotag.compute", "device.phase_refine.h2d"} <= \
            set(m["spans"])
    with open(os.path.join(out, "profile", "idle_by_span.json")) as f:
        idle = json.load(f)
    assert set(idle["spans"]) == set(m["spans"])
    owned = sum(v["idle_s"] for v in idle["spans"].values())
    assert owned + idle[OUTSIDE]["idle_s"] == \
        pytest.approx(idle["idle_s"], abs=1e-9)
    assert idle["busy_s"] == 0.0   # no card: every instant is idle


def ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}


EVENTS = [
    ev("user_annotation", "stage", 0, 100),
    ev("user_annotation", "stage.child", 20, 40),
    ev("user_annotation", "stage.child.leaf", 30, 10),
    ev("user_annotation", "pool.work", 50, 30),    # another thread's span
    ev("user_annotation", "stage:harness", 0, 110),  # not a program span
    ev("cpu_op", "aten::add", 0, 120),
    ev("kernel", "k1", 10, 10),
    ev("kernel", "k2", 15, 10),                      # overlaps k1
    ev("gpu_memcpy", "Memcpy HtoD", 35, 10),
    ev("gpu_memset", "Memset", 70, 5),
    ev("ac2g", "flow", 5, 0),
]
NAMES = {"stage", "stage.child", "stage.child.leaf", "pool.work"}


def test_idle_by_span_adds_up_exactly():
    """Window [0, 120), busy [10, 25) + [35, 45) + [70, 75) = 30 us; each
    idle instant to the span entered last and still open."""
    got = idle_by_span(EVENTS, NAMES)
    us = {name: v["idle_s"] * 1e6 for name, v in got["spans"].items()}
    us[OUTSIDE] = got[OUTSIDE]["idle_s"] * 1e6
    # idle [0,10) [25,35) [45,70) [75,120): stage [0,10) [80,100); child
    # [25,30) [45,50); leaf [30,35); pool.work, entered last from 50,
    # [50,70) [75,80); outside [100,120)
    want = {"stage": 10 + 20, "stage.child": 5 + 5, "stage.child.leaf": 5,
            "pool.work": 20 + 5, OUTSIDE: 20}
    assert us == pytest.approx(want, abs=1e-9)
    assert sum(want.values()) == 90
    assert got["window_s"] * 1e6 == pytest.approx(120)
    assert got["busy_s"] * 1e6 == pytest.approx(30)
    assert got["idle_s"] * 1e6 == pytest.approx(90)
    host = {n: v["host_s"] * 1e6 for n, v in got["spans"].items()}
    assert host == pytest.approx({"stage": 100, "stage.child": 40,
                                  "stage.child.leaf": 10, "pool.work": 30})
    busy = {n: v["busy_s"] * 1e6 for n, v in got["spans"].items()}
    assert busy == pytest.approx({"stage": 30, "stage.child": 15,
                                  "stage.child.leaf": 5, "pool.work": 5})


def test_idle_by_span_of_a_trace_with_no_program_span():
    got = idle_by_span(EVENTS, set())
    assert got["spans"] == {}
    assert got[OUTSIDE]["idle_s"] == pytest.approx(got["idle_s"])
    assert idle_by_span([], NAMES)["window_s"] == 0.0
