"""The torch port's multi-process runs against duet_tpu's on the CPU:
contig ownership, part-file exchange, the global breakend merge and
single-writer emission, byte-identical to the port's single-process run
and to duet_tpu's two-process run.

As in tests/test_multiprocess.py the processes are EMULATED: two
sequential runs against one shared OUTPUT dir with (process_id,
num_processes) set and no coordinator.  One test runs two real processes
joined by torch.distributed (gloo) at a local coordinator."""

import gzip
import json
import os
import socket
import subprocess
import sys

import pytest

from duet_tpu.pipeline import PipelineConfig as JaxConfig
from duet_tpu.pipeline import _owned_contigs as j_owned
from duet_tpu.pipeline import run_pipeline as jax_run
from duet_tpu_torch.pipeline import (
    PipelineConfig,
    _owned_contigs,
    run_phase_only,
    run_pipeline,
    run_pipeline_streaming,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = ("snp_calling/pileup.vcf.gz", "sv_calling/variants.vcf",
             "phased_sv.vcf")


def _read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def _cfg(d, out, **kw):
    """The port's config: device routes on the CPU under 'on'."""
    return PipelineConfig(bam=f"{d}/reads.bam", reference=f"{d}/ref.fa",
                          output=str(out), include_all_ctgs=True,
                          device="cpu", device_stages="on", **kw)


def _jcfg(d, out, **kw):
    """duet_tpu's config of tests/test_multiprocess.py."""
    return JaxConfig(bam=f"{d}/reads.bam", reference=f"{d}/ref.fa",
                     output=str(out), use_device_kernel=False,
                     include_all_ctgs=True, **kw)


def _two_process(make_cfg, d, shared, **kw):
    """Process 1 first, so process 0 merges last (the barrier's order)."""
    run_pipeline(make_cfg(d, shared, num_processes=2, process_id=1, **kw))
    return run_pipeline(make_cfg(d, shared, num_processes=2, process_id=0,
                                 **kw))


def _jax_two_process(d, shared, **kw):
    jax_run(_jcfg(d, shared, num_processes=2, process_id=1, **kw))
    return jax_run(_jcfg(d, shared, num_processes=2, process_id=0, **kw))


@pytest.fixture(scope="module")
def multi_demo(tmp_path_factory):
    """Three 120 kb contigs with a translocation between two of them
    (tests/test_multiprocess.py's dataset), and the runs the tests share:
    the port's single-process and two-process runs and duet_tpu's
    two-process run."""
    from duet_tpu.sim import SimConfig, simulate_dataset

    root = tmp_path_factory.mktemp("mp")
    d = root / "data"
    truth = simulate_dataset(str(d), SimConfig(
        contigs={"chrA": 120_000, "chrB": 120_000, "chrC": 120_000},
        seed=11, coverage=18.0, tra_count=1,
    ))
    single = root / "single"
    run_pipeline(_cfg(d, single))
    shared = root / "shared"
    _two_process(_cfg, d, shared)
    jax_shared = root / "jax_shared"
    _jax_two_process(d, jax_shared)
    return d, truth, single, shared, jax_shared


def test_ownership_partition():
    names = ["chrB", "chrA", "chrC", "chrD"]
    parts = [_owned_contigs(names, pid, 3) for pid in range(3)]
    assert sorted(sum(parts, [])) == sorted(names)       # complete
    assert not set(parts[0]) & set(parts[1])             # disjoint
    # deterministic regardless of input order, and duet_tpu's assignment
    assert parts == [_owned_contigs(names[::-1], pid, 3) for pid in range(3)]
    assert parts == [j_owned(names, pid, 3) for pid in range(3)]


def test_two_process_run_equals_single(multi_demo):
    _, _, single, shared, jax_shared = multi_demo
    for name in ARTIFACTS:
        want = _read(os.path.join(single, name))
        assert _read(os.path.join(shared, name)) == want, name
        assert _read(os.path.join(jax_shared, name)) == want, name
    assert sorted(os.listdir(shared / "snp_phasing")) == \
        sorted(os.listdir(single / "snp_phasing"))
    # the parts, the non-owner's log and metrics; no final artifact of its own
    for name in ("parts/sv.part0.pkl", "parts/sv.part1.pkl",
                 "parts/snp.part0.pkl", "parts/snp.part1.pkl",
                 "run_duet.p1.log", "metrics.p1.json"):
        assert os.path.exists(shared / name), name
    assert not os.path.exists(shared / "run_duet.p0.log")


def test_cross_process_bnd_junction(multi_demo):
    """The translocation pairs two contigs; with 2 processes the round-robin
    puts them on DIFFERENT owners, so the junction is only callable from the
    merged evidence on process 0."""
    _, truth, _, shared, _ = multi_demo
    (ca, pa, cb, pb, _), = truth.tra
    assert ca != cb
    assert _owned_contigs([ca, cb, "chrA", "chrB", "chrC"], 0, 2) != \
        _owned_contigs([ca, cb, "chrA", "chrB", "chrC"], 1, 2)
    bnd_lines = [ln for ln in open(shared / "sv_calling" / "variants.vcf")
                 if "SVTYPE=BND" in ln]
    assert bnd_lines, "cross-process breakend must survive the merge"
    assert any(
        ln.split("\t")[0] == ca
        and abs(int(ln.split("\t")[1]) - (pa + 1)) <= 100
        for ln in bnd_lines), f"junction {ca}:{pa} not found"


def test_per_process_metrics(multi_demo):
    _, _, _, shared, jax_shared = multi_demo
    m0 = json.load(open(shared / "metrics.json"))
    m1 = json.load(open(shared / "metrics.p1.json"))
    # each process ingested only its owned contigs
    assert m0["counts"]["contigs"] + m1["counts"]["contigs"] == 3
    for name in ("metrics.json", "metrics.p1.json"):
        want = json.load(open(jax_shared / name))
        got = json.load(open(shared / name))
        assert got["counts"] == want["counts"], name
        assert got["backends"]["haplotag"] == "device", name


def test_flag_validation(multi_demo, tmp_path):
    d = multi_demo[0]
    with pytest.raises(ValueError, match="requires --process-id"):
        run_pipeline(_cfg(d, tmp_path / "x", num_processes=2))
    with pytest.raises(ValueError, match="out of range"):
        run_pipeline(_cfg(d, tmp_path / "x", num_processes=2, process_id=2))
    with pytest.raises(ValueError, match="resume"):
        run_pipeline(_cfg(d, tmp_path / "x", num_processes=2, process_id=0,
                          resume=True))
    with pytest.raises(ValueError, match="stream"):
        run_pipeline_streaming(_cfg(d, tmp_path / "x", num_processes=2,
                                    process_id=0))
    with pytest.raises(ValueError, match="single-process"):
        run_phase_only(_cfg(d, tmp_path / "x", num_processes=2,
                            process_id=0))


def test_merge_keeps_bam_header_contig_order(tmp_path):
    """chr10 sorts lexicographically BEFORE chr2: the part merge must keep
    BAM header order or multi-process artifacts diverge byte-wise."""
    from duet_tpu.sim import SimConfig, simulate_dataset

    d = tmp_path / "data"
    simulate_dataset(str(d), SimConfig(
        contigs={"chr2": 100_000, "chr10": 100_000}, seed=13, coverage=16.0))
    single = run_pipeline(_cfg(d, tmp_path / "single"))
    shared = tmp_path / "shared"
    multi = _two_process(_cfg, d, shared)
    jax_multi = _jax_two_process(d, tmp_path / "jax_shared")
    sv = "sv_calling/variants.vcf"
    assert _read(str(shared / sv)) == _read(str(tmp_path / "single" / sv))
    assert _read(multi) == _read(single) == _read(jax_multi)


def test_two_process_mesh_equals_single_device(tmp_path):
    """Composition: two emulated processes, EACH sharding its stages over
    a 2 x 2 mesh, equal the single-process single-device run (as
    tests/test_mesh_multiprocess.py pins duet_tpu's), and duet_tpu's
    two-process mesh run."""
    from duet_tpu.sim import SimConfig, simulate_dataset

    d = tmp_path / "data"
    simulate_dataset(str(d), SimConfig(
        contigs={"chrA": 120_000, "chrB": 120_000}, seed=13, coverage=16.0))
    single = run_pipeline(PipelineConfig(
        bam=f"{d}/reads.bam", reference=f"{d}/ref.fa",
        output=str(tmp_path / "single"), include_all_ctgs=True,
        device="cpu"))
    shared = tmp_path / "shared"

    def cfg(d, out, **kw):
        return PipelineConfig(bam=f"{d}/reads.bam", reference=f"{d}/ref.fa",
                              output=str(out), include_all_ctgs=True,
                              device="cpu", mesh="2,2", **kw)

    multi = _two_process(cfg, d, shared)
    jax_shared = tmp_path / "jax_shared"
    jax_run(JaxConfig(bam=f"{d}/reads.bam", reference=f"{d}/ref.fa",
                      output=str(jax_shared), include_all_ctgs=True,
                      num_processes=2, process_id=1, mesh="2,2"))
    jax_multi = jax_run(JaxConfig(
        bam=f"{d}/reads.bam", reference=f"{d}/ref.fa",
        output=str(jax_shared), include_all_ctgs=True, num_processes=2,
        process_id=0, mesh="2,2"))
    for name in ARTIFACTS:
        assert _read(str(shared / name)) == \
            _read(str(tmp_path / "single" / name)), name
    assert _read(multi) == _read(single) == _read(jax_multi)
    for name in ("metrics.json", "metrics.p1.json"):
        m = json.load(open(shared / name))
        assert m["mesh"] == {"dp": 2, "sp": 2}
        assert m["backends"]["haplotag"] == "mesh"
    n = sum(1 for ln in open(multi) if ln.strip() and not ln.startswith("#"))
    assert n > 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_real_coordinator_two_processes(multi_demo, tmp_path):
    """Two `python -m duet_tpu_torch` processes joined by torch.distributed
    (gloo) at a local coordinator: the barrier holds process 0 until
    process 1's parts exist, and phased_sv.vcf equals the single-process
    run's."""
    d, _, single, _, _ = multi_demo
    out = str(tmp_path / "shared")
    addr = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "duet_tpu_torch", f"{d}/reads.bam",
         f"{d}/ref.fa", out, "-a", "-t", "2", "--device", "cpu",
         "--device-stages", "on", "--coordinator", addr,
         "--num-processes", "2", "--process-id", str(pid)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in (1, 0)]
    try:
        results = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    assert _read(os.path.join(out, "phased_sv.vcf")) == \
        _read(os.path.join(single, "phased_sv.vcf"))
    assert os.path.exists(os.path.join(out, "metrics.p1.json"))
    with open(os.path.join(out, "run_duet.log")) as f:
        assert "barrier: pre-merge" in f.read()


@pytest.mark.parametrize("n_reads,batch,nproc", [(1000, 128, 2), (77, 10, 3),
                                                  (5, 8, 4)])
def test_host_read_batches_matches_duet(n_reads, batch, nproc):
    from duet_tpu.parallel.distributed import host_read_batches as j_batches
    from duet_tpu_torch.parallel import host_read_batches

    got = [host_read_batches(n_reads, batch, pid, nproc)
           for pid in range(nproc)]
    assert got == [j_batches(n_reads, batch, pid, nproc)
                   for pid in range(nproc)]
    rows = sorted(r for part in got for lo, hi in part for r in range(lo, hi))
    assert rows == list(range(n_reads))


def test_global_mesh_and_single_process_gather():
    import numpy as np

    from duet_tpu_torch.parallel import gather_rows, global_mesh

    mesh = global_mesh(sp=2, device="cpu")
    assert mesh.shape == {"dp": 4, "sp": 2}
    with pytest.raises(ValueError, match="not divisible by sp=3"):
        global_mesh(sp=3, device="cpu")
    rows = np.arange(12, dtype=np.int32).reshape(4, 3)
    np.testing.assert_array_equal(gather_rows(mesh, rows), rows)


def test_gather_rows_across_two_processes():
    """gather_rows in a two-process gloo group: each process's rows, in
    rank order, on both processes."""
    addr = f"127.0.0.1:{_free_port()}"
    script = (
        "import sys, numpy as np\n"
        "from duet_tpu_torch.parallel import gather_rows, init_distributed\n"
        "pid = int(sys.argv[1])\n"
        f"init_distributed({addr!r}, 2, pid)\n"
        "rows = np.full((2, 3), pid + 1, np.int32)\n"
        "print(gather_rows(None, rows).ravel().tolist())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(pid)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for pid in (0, 1)]
    try:
        results = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, err[-2000:]
        assert out.split("\n")[-2] == str([1] * 6 + [2] * 6)
