"""The torch port's batch pipeline end to end: byte-identical artifacts
against duet_tpu's run_pipeline under --device-stages on and off, a run
that never imports jax (in a subprocess, since this test process has jax
loaded), and a --device cuda run on a host without a card (--stream,
--resume and --phase-only are held against duet_tpu in
test_torch_modes.py, --mesh in test_torch_mesh.py, multi-process runs in
test_torch_multiprocess.py and --profile in test_torch_profile.py)."""

import gzip
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from duet_tpu.pipeline import PipelineConfig as JaxConfig
from duet_tpu.pipeline import run_pipeline as jax_run
from duet_tpu.utils.devcost import _FIELDS
from duet_tpu_torch.pipeline import PipelineConfig, run_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("snp_pileup", "sv_cluster", "phase_refine", "haplotag", "sv_decide")


def _read(path):
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _artifacts(out):
    names = ["snp_calling/pileup.vcf.gz", "sv_calling/variants.vcf",
             "phased_sv.vcf"]
    return names + [f"snp_phasing/{n}"
                    for n in sorted(os.listdir(os.path.join(out,
                                                            "snp_phasing")))]


@pytest.mark.parametrize("mode,backend", [("on", "device"), ("off", "host")])
def test_artifacts_match_jax_pipeline(sim_dataset, tmp_path, mode, backend):
    data, _, _ = sim_dataset
    paths = dict(bam=os.path.join(data, "reads.bam"),
                 reference=os.path.join(data, "ref.fa"))
    want = str(tmp_path / "jax")
    got = str(tmp_path / "torch")
    jax_run(JaxConfig(output=want, device_stages=mode, **paths))
    run_pipeline(PipelineConfig(output=got, device_stages=mode, device="cpu",
                                **paths))
    assert _artifacts(got) == _artifacts(want)
    for name in _artifacts(want):
        assert _read(os.path.join(got, name)) == \
            _read(os.path.join(want, name)), name
    with open(os.path.join(got, "metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(want, "metrics.json")) as f:
        ref_keys = set(json.load(f))
    assert set(metrics) == ref_keys | {"device", "spans", "counters"}
    # the port's BGZF inflate label too: its card route runs on CUDA only
    assert metrics["backends"] == {**dict.fromkeys(STAGES, backend),
                                   "ingest_inflate": "host"}
    assert metrics["device"] == {"type": "cpu", "name": None}
    for stage, row in metrics["device_cost"].items():
        assert tuple(row) == _FIELDS, stage
    if mode == "on":
        assert set(metrics["device_cost"]) == set(STAGES)


def test_cli_run_imports_no_jax(tmp_path):
    """`python -m duet_tpu_torch ... --device cpu --device-stages on` in a
    fresh interpreter whose import system refuses jax, jaxlib, ml_dtypes,
    optax and the JAX package duet_tpu: the whole device-stage pipeline
    runs, and the bench module imports."""
    from duet_tpu.sim import SimConfig, simulate_dataset

    data = str(tmp_path / "data")
    out = str(tmp_path / "out")
    simulate_dataset(data, SimConfig(contigs={"chr1": 60_000}, seed=5,
                                     coverage=10.0))
    script = textwrap.dedent(f"""
        import importlib.abc, runpy, sys
        BLOCKED = ("jax", "jaxlib", "ml_dtypes", "optax", "duet_tpu")

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("refused import of " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import duet_tpu_torch.bench
        sys.argv = ["duet_tpu_torch", {data!r} + "/reads.bam",
                    {data!r} + "/ref.fa", {out!r}, "--device", "cpu",
                    "--device-stages", "on", "-t", "2"]
        try:
            runpy.run_module("duet_tpu_torch", run_name="__main__",
                             alter_sys=True)
        except SystemExit as e:
            assert e.code == 0, e.code
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not loaded, loaded
        print("NO_JAX_RUN_OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_RUN_OK" in proc.stdout
    with open(os.path.join(out, "metrics.json")) as f:
        backends = json.load(f)["backends"]
    assert backends["snp_pileup"] == backends["haplotag"] == "device"
    assert os.path.exists(os.path.join(out, "phased_sv.vcf"))


def test_cuda_device_without_card(sim_dataset, tmp_path):
    """--device cuda on a host with no card: a host-only run works, and a
    device route raises instead of sliding to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    data, _, _ = sim_dataset
    paths = dict(bam=os.path.join(data, "reads.bam"),
                 reference=os.path.join(data, "ref.fa"))
    run_pipeline(PipelineConfig(output=str(tmp_path / "off"),
                                device_stages="off", **paths))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pipeline(PipelineConfig(output=str(tmp_path / "on"),
                                    device_stages="on", **paths))


def test_auto_gates_stay_on_host_for_cpu_device(sim_dataset, tmp_path):
    """'auto' uses the device only when it is a GPU: with --device cpu
    every stage runs on the host, and the gates are recorded: the port's
    H100 gates and scorer (a named deviation from duet_tpu's record of its
    TPU fast-link gates, which has no pileup, decision or scorer entry)."""
    data, _, _ = sim_dataset
    out = str(tmp_path / "auto")
    run_pipeline(PipelineConfig(bam=os.path.join(data, "reads.bam"),
                                reference=os.path.join(data, "ref.fa"),
                                output=out, device="cpu"))
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    assert metrics["backends"] == {**dict.fromkeys(STAGES, "host"),
                                   "ingest_inflate": "host"}
    assert metrics["device_size_gates"] == {
        "pileup_min_bases": None, "pileup_contig_min_bases": None,
        "sv_cluster_min_signatures": 64_000,
        "phasing_min_nnz": 49_995, "decide_min_calls": None,
        "haplotag_mode": "sparse"}
    assert not {"h2d_probe_mb_s", "h2d_worst_put_s"} & \
        set(metrics["device_size_gates"])
    want = str(tmp_path / "jax")
    jax_run(JaxConfig(bam=os.path.join(data, "reads.bam"),
                      reference=os.path.join(data, "ref.fa"), output=want))
    assert _artifacts(out) == _artifacts(want)
    for name in _artifacts(want):
        assert _read(os.path.join(out, name)) == \
            _read(os.path.join(want, name)), name
    with open(os.path.join(want, "metrics.json")) as f:
        jax_gates = json.load(f)["device_size_gates"]
    assert jax_gates["sv_cluster_min_signatures"] != 64_000
    assert jax_gates["phasing_min_nnz"] != 49_995
