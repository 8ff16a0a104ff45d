"""GPU smoke run of the duet_tpu_torch port: `python3 chip_smoke.py`.

Needs one CUDA card (Hopper, sm_90a) and nvcc; builds the port's CUDA
kernels from the sources in this checkout.  Phases, each printing one line:

  1. the card (name and power limit from nvidia-smi), torch/CUDA versions
     and the kernel build time;
  2. the haplotag scoring kernel against its plain torch version on the
     card, at the pipeline's launch shape and on edge cases, with
     torch.equal on hap/pc/best, and the median time of each;
  3. the neural SNP caller's forward pass on the card against the CPU;
  4. a simulated dataset (2 contigs x 5 Mb, 20x, fixed seed);
  5. the batch pipeline through the port's CLI with --device-stages on,
     asserting every stage ran on the device and the kernel launched;
  6. the same CLI with --device-stages off, asserting byte-identical
     artifacts.

Any failure exits non-zero.  The second-to-last line is one JSON object
describing the kernels; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

TOLERANCE = "exact (torch.equal on int32 hap/pc/best)"


def _median_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def pipeline_shaped_inputs(seed: int, n_tasks: int = 16, rows: int = 256,
                           S: int = 2304, K: int = 128, n_blocks: int = 126):
    """Chunks shaped like the pipeline's: position-sorted reads covering
    short runs of het sites, alleles +-1, integer weights <= 40, phase
    +-1 with some unphased sites, and a one-hot table of contiguous
    phase-set blocks."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n_tasks * rows, S), np.int8)
    W = np.zeros((n_tasks * rows, S), np.float32)
    rhs = np.zeros((n_tasks * S, K), np.float32)
    for t in range(n_tasks):
        starts = np.sort(rng.integers(0, S, rows))
        spans = rng.integers(5, 80, rows)
        for r in range(rows):
            lo, hi = starts[r], min(starts[r] + spans[r], S)
            cov = rng.random(hi - lo) < 0.9
            cols = np.arange(lo, hi)[cov]
            A[t * rows + r, cols] = rng.choice([-1, 1], len(cols))
            W[t * rows + r, cols] = rng.integers(1, 41, len(cols))
        phase = rng.choice([-1.0, 1.0], S) * (rng.random(S) > 0.05)
        nb = int(rng.integers(1, n_blocks + 1))
        cuts = np.sort(rng.choice(np.arange(1, S), nb - 1, replace=False))
        block = np.searchsorted(cuts, np.arange(S), side="right")
        block[rng.random(S) < 0.02] = -1          # sites outside any block
        blk = rhs[t * S:(t + 1) * S]
        blk[:, 0] = phase
        blk[:, 1] = phase != 0
        ok = block >= 0
        blk[np.flatnonzero(ok), 2 + block[ok]] = 1.0
    return A, W, rhs


def edge_case_inputs(seed: int):
    """Small odd shapes: S and rows off the tile sizes, K < 128, tied
    block weights, all-zero rows, rows whose sites are all unphased."""
    rows, S, K, T = 100, 1000, 40, 3
    A, W, rhs = pipeline_shaped_inputs(seed, T, rows, S, K, K - 2)
    rng = np.random.default_rng(seed + 1)
    for t in range(T):
        base = t * rows
        A[base + 0] = 0                            # total 0
        W[base + 0] = 0
        blk = rhs[t * S:(t + 1) * S]
        blk[500:520, 0] = 0                        # unphased sites
        blk[500:520, 1] = 0
        A[base + 1] = 0
        A[base + 1, 500:520] = 1
        W[base + 1, 500:520] = 7
        # tie: two blocks with the same summed weight on one read
        blk[600:610, 2:] = 0
        blk[600:605, 2 + 4] = 1
        blk[605:610, 2 + 9] = 1
        A[base + 2] = 0
        A[base + 2, 600:610] = rng.choice([-1, 1], 10)
        W[base + 2, 600:610] = 20
        A[base + 3] = -A[base + 3]                 # flip to negative signed
    return A, W, rhs, T, K - 2


def phase_card(report: dict) -> None:
    import torch

    from duet_tpu_torch.ops import cuda_build, haplotag_kernel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    report["card"] = smi.stdout.strip().splitlines()[0]
    haplotag_kernel._library()
    info = cuda_build.BUILD_INFO["haplotag_score"]
    print(f"[card] {report['card']} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | haplotag_score built in {info['seconds']} s "
          f"(fresh build: {info['built']})", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[card] ptxas: {line.strip()}", flush=True)


def phase_kernel(report: dict) -> None:
    import torch

    from duet_tpu_torch.ops.haplotag import phase_and_tag_batch
    from duet_tpu_torch.ops.haplotag_kernel import haplotag_score_batch

    def on_card(A, W, rhs):
        return (torch.from_numpy(A).cuda(),
                torch.from_numpy(W).to(torch.bfloat16).cuda(),
                torch.from_numpy(rhs).to(torch.bfloat16).cuda())

    worst = 0
    A, W, rhs = pipeline_shaped_inputs(seed=2024)
    a, w, r = on_card(A, W, rhs)
    got = haplotag_score_batch(a, w, r, 16, 126)
    want = phase_and_tag_batch(a, w, r, 16, 126)
    torch.cuda.synchronize()
    for name, g, x in zip(("hap", "pc", "best"), got, want):
        if not torch.equal(g, x):
            raise AssertionError(f"kernel != plain on {name} at the "
                                 "pipeline shape")
        worst = max(worst, int((g - x).abs().max()))
    tagged = float((got[0] != 0).float().mean())
    ms = _median_ms(lambda: haplotag_score_batch(a, w, r, 16, 126))
    plain_ms = _median_ms(lambda: phase_and_tag_batch(a, w, r, 16, 126))
    for seed in (1, 2, 3):
        A, W, rhs, T, nb = edge_case_inputs(seed)
        a2, w2, r2 = on_card(A, W, rhs)
        got2 = haplotag_score_batch(a2, w2, r2, T, nb)
        want2 = phase_and_tag_batch(a2, w2, r2, T, nb)
        for name, g, x in zip(("hap", "pc", "best"), got2, want2):
            if not torch.equal(g, x):
                raise AssertionError(f"kernel != plain on {name}, edge case "
                                     f"seed {seed}")
    report["kernel"] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": worst}
    print(f"[kernel] haplotag_score == plain ({TOLERANCE}) at T=16 x 256 "
          f"rows, S=2304, K=128, n_blocks=126 ({tagged:.3f} rows tagged) and "
          f"on 3 edge-case sets; median {ms:.4f} ms vs plain "
          f"{plain_ms:.4f} ms on {report['card']}", flush=True)


def phase_nn(report: dict) -> None:
    import torch

    from duet_tpu_torch.models.nn_snp import N_FEATURES, load_model

    x = np.random.default_rng(7).random((8192, N_FEATURES), np.float32)
    with torch.no_grad():
        gpu = load_model(device=torch.device("cuda"))(
            torch.from_numpy(x).cuda()).cpu()
        cpu = load_model()(torch.from_numpy(x))
    if not torch.equal(gpu.argmax(1), cpu.argmax(1)):
        raise AssertionError("SnpMLP argmax differs between card and CPU")
    diff = float((gpu - cpu).abs().max())
    print(f"[nn] SnpMLP forward on the card == CPU argmax on 8192 rows "
          f"(max |logit diff| {diff:.3e}, float32, TF32 off)", flush=True)


def phase_simulate(report: dict, work: str) -> str:
    from duet_tpu_torch.sim import SimConfig, simulate_dataset

    t = time.perf_counter()
    data = os.path.join(work, "data")
    simulate_dataset(data, SimConfig(
        contigs={"chr1": 5_000_000, "chr2": 5_000_000}, coverage=20.0,
        seed=11))
    print(f"[sim] 2 contigs x 5 Mb at 20x (seed 11) in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return data


def _run_cli(data: str, out: str, mode: str) -> dict:
    from duet_tpu_torch.cli import main as cli_main

    rc = cli_main([os.path.join(data, "reads.bam"),
                   os.path.join(data, "ref.fa"), out,
                   "--device-stages", mode])
    if rc != 0:
        raise AssertionError(f"duet-tpu-torch --device-stages {mode} "
                             f"exited {rc}")
    with open(os.path.join(out, "metrics.json")) as f:
        return json.load(f)


def phase_pipeline_on(report: dict, data: str, work: str) -> None:
    import torch

    from duet_tpu_torch.ops import haplotag_kernel

    torch.cuda.synchronize()
    haplotag_kernel.LAUNCHES = 0
    metrics = _run_cli(data, os.path.join(work, "on"), "on")
    report["launches"] = haplotag_kernel.LAUNCHES
    backends = metrics["backends"]
    wrong = {s: b for s, b in backends.items() if b != "device"}
    if wrong:
        raise AssertionError(f"stages not on the device: {wrong}")
    if report["launches"] < 1:
        raise AssertionError("the haplotag kernel never launched")
    report["pipeline_on"] = metrics
    print(f"[pipeline on] backends all device, haplotag_score launches "
          f"{report['launches']}, ingest {metrics['ingest']['backend']}, "
          f"reads {metrics['counts']['reads']}, snp sites "
          f"{metrics['counts']['snp_sites']}, tagged reads "
          f"{metrics['counts']['tagged_reads']}, total "
          f"{metrics['total_s']} s, stages {json.dumps(metrics['stages'])}, "
          f"device_cost {json.dumps(metrics['device_cost'])}", flush=True)


def _read(path: str) -> bytes:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def phase_pipeline_off(report: dict, data: str, work: str) -> None:
    from duet_tpu_torch.ops import haplotag_kernel

    before = haplotag_kernel.LAUNCHES
    metrics = _run_cli(data, os.path.join(work, "off"), "off")
    if haplotag_kernel.LAUNCHES != before:
        raise AssertionError("--device-stages off launched the kernel")
    on, off = os.path.join(work, "on"), os.path.join(work, "off")
    names = ["snp_calling/pileup.vcf.gz", "sv_calling/variants.vcf",
             "phased_sv.vcf"]
    names += [f"snp_phasing/{n}"
              for n in sorted(os.listdir(os.path.join(on, "snp_phasing")))]
    if sorted(os.listdir(os.path.join(off, "snp_phasing"))) != \
            sorted(os.listdir(os.path.join(on, "snp_phasing"))):
        raise AssertionError("snp_phasing/ holds different files on and off")
    for name in names:
        if _read(os.path.join(on, name)) != _read(os.path.join(off, name)):
            raise AssertionError(f"{name} differs between on and off")
    with open(os.path.join(on, "phased_sv.vcf")) as f:
        n_phased = sum(1 for ln in f if ln.strip() and not ln.startswith("#"))
    if n_phased == 0:
        raise AssertionError("the run phased no SV call")
    print(f"[pipeline off] {len(names)} artifacts byte-identical to the "
          f"device run ({n_phased} phased SV calls); host total "
          f"{metrics['total_s']} s, stages {json.dumps(metrics['stages'])}",
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    report: dict = {}
    work = tempfile.mkdtemp(prefix="duet_chip_smoke_")
    try:
        phase_card(report)
        phase_kernel(report)
        phase_nn(report)
        data = phase_simulate(report, work)
        phase_pipeline_on(report, data, work)
        phase_pipeline_off(report, data, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(report["card"])
    print(json.dumps({"kernels": [{
        "name": "haplotag_score",
        "route": "cuda",
        "source": "duet_tpu_torch/csrc/haplotag_score.cu",
        "replaces": "duet_tpu/ops/pallas_haplotag.py:92",
        "launches": report["launches"],
        "max_abs_err": report["kernel"]["max_abs_err"],
        "ms": report["kernel"]["ms"],
        "plain_ms": report["kernel"]["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
