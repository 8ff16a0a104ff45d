"""One run of one cell: set-up, the cold sample, the measured window, the
traced samples, and the check against the plain reference.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the simulator's parameters) and a traffic mix (``traffic/<name>.json``: the
entry point and the pipeline's flags); ``workloads/<cell>.json`` holds the
limits of the numbers that decide ``correct``, and ``metrics/<metric>.py``
the reader of each metric.  The harness reads them by name and holds
nothing of any one cell.

A sample is one whole call of the traffic's entry on one of the cell's
inputs (a BAM and a FASTA), into an output directory of its own:
``duet_tpu_torch.pipeline``'s ``run_pipeline`` under ``"entry": "batch"``
(or no ``entry``), its ``run_pipeline_streaming`` (``--stream``, contig by
contig) under ``"entry": "stream"``.  Samples run one after another, in
this process.  A traffic's ``"inputs": K`` (1 when absent) has the run
simulate K inputs from the seed and take them in turn, so that the window
holds about as many samples of each: the run's first input from the seed
itself, the others from seeds drawn from it (``input_seeds``).
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from multiprocessing import get_context

from h100_bench import clock, compare, trace

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "duet_tpu")
TRACED_SAMPLES = 3
# a traffic's "entry" -> the function of duet_tpu_torch.pipeline it calls
ENTRIES = {"batch": "run_pipeline", "stream": "run_pipeline_streaming"}


@dataclass
class Cell:
    """A cell of the manifest with its files read."""

    name: str
    chips: int
    config_path: str
    traffic: dict
    limits: dict
    end_to_end: list[str]
    per_layer: list[str]


@dataclass
class Run:
    """What a run measured; the metric readers take their numbers from it."""

    setup_s: float = 0.0
    cold_s: float = 0.0
    cold_metrics: dict = field(default_factory=dict)
    cold_peaks: dict = field(default_factory=dict)
    sample_s: list[float] = field(default_factory=list)
    sample_metrics: list[dict] = field(default_factory=list)
    sample_stages: list[dict] = field(default_factory=list)
    window_s: float = 0.0
    peak_host_mb: float = 0.0
    trace: trace.Trace | None = None


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of ``BENCHMARK.json`` and its files."""
    manifest = _load(os.path.join(root, "BENCHMARK.json"))
    entry = {w["name"]: w for w in manifest["workloads"]}.get(name)
    if entry is None:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")

    def applies(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    traffic = _load(os.path.join(BENCH_DIR, "traffic",
                                 entry["traffic"] + ".json"))
    inputs = traffic.get("inputs", 1)
    if type(inputs) is not int or inputs < 1:
        raise SystemExit(f"cell {name!r}: traffic {entry['traffic']!r} has "
                         f"inputs {inputs!r}, not a whole number from 1")
    if traffic.get("entry", "batch") not in ENTRIES:
        raise SystemExit(f"cell {name!r}: traffic {entry['traffic']!r} has "
                         f"entry {traffic['entry']!r}, not one of "
                         f"{sorted(ENTRIES)}")
    refused = compare.unhonoured(traffic["pipeline"])
    if refused:
        raise SystemExit(f"cell {name!r}: traffic {entry['traffic']!r} sets "
                         f"{', '.join(refused)}, which the plain reference "
                         f"cannot honour")
    return Cell(
        name=name, chips=entry["chips"],
        config_path=os.path.join(BENCH_DIR, "configs",
                                 entry["config"] + ".json"),
        traffic=traffic,
        limits=_load(os.path.join(BENCH_DIR, "workloads",
                                  name + ".json"))["limits"],
        end_to_end=[m["name"] for m in manifest["end_to_end"] if applies(m)],
        per_layer=[m["name"] for m in manifest["per_layer"] if applies(m)],
    )


def cache_env() -> None:
    """Keep every build and kernel cache of the program inside the
    checkout, at fixed paths (the program's own nvcc and g++ builds already
    go to ``build/duet_tpu_torch/``)."""
    base = os.path.join(ROOT, "build", "h100_bench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def _child(args: list[str]) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *args], cwd=ROOT,
                            stdout=subprocess.PIPE, text=True)


def _wait(proc: subprocess.Popen, what: str) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{what} exited with {proc.returncode}")
    return out


def input_seeds(seed: int, inputs: int) -> list[int]:
    """The simulator's seed of each of a run's `inputs` inputs: the run's
    own seed, then seeds drawn from it."""
    import numpy as np

    drawn = np.random.SeedSequence(seed).generate_state(inputs - 1,
                                                         np.uint64)
    return [seed] + [int(s) for s in drawn]


def prepare(cell: Cell, seed: int, work: str, card: bool,
            inputs: int | None = None) -> tuple[dict, list[str]]:
    """Write the cell's inputs from the seed (`inputs`, by default the
    traffic's), and build the program's kernels and native ingest, in
    child processes at once, so that neither the simulator's memory nor a
    build touches this process.  With `card`, the build child also reports
    the cards it sees; without it (the CPU tests) it builds nothing.
    Returns (the cards, each input's directory under `work`)."""
    seeds = input_seeds(seed, inputs or cell.traffic.get("inputs", 1))
    datas = [os.path.join(work, "data" + (str(i) if i else ""))
             for i in range(len(seeds))]
    sims = [_child(["-m", "h100_bench.sim", cell.config_path, str(s), d])
            for s, d in zip(seeds, datas)]
    build = _child(["-m", "h100_bench.build"] + ([] if card else ["--none"]))
    try:
        cards = json.loads(_wait(build, "the build").strip().splitlines()[-1])
    finally:
        for sim in sims:
            _wait(sim, "the simulator")
    return cards, datas


def _pipeline_config(cell: Cell, data: str, out: str, device: str):
    from duet_tpu_torch.pipeline import PipelineConfig

    return PipelineConfig(bam=os.path.join(data, "reads.bam"),
                          reference=os.path.join(data, "ref.fa"),
                          output=out, device=device,
                          **cell.traffic["pipeline"])


def sample(cell: Cell, data: str, out: str, device: str,
           peaks: dict | None = None) -> tuple[float, dict, dict]:
    """One whole sample through the traffic's entry: (wall seconds, its
    metrics.json, each stage's seconds on the harness's clock); `peaks`
    takes the high-water mark in MB as each stage ends."""
    from duet_tpu_torch import pipeline

    entry = cell.traffic.get("entry", "batch")
    run = getattr(pipeline, ENTRIES[entry])
    cfg = _pipeline_config(cell, data, out, device)
    stages: dict = {}
    with clock.stage_clock(stages, peaks, entry):
        t = time.perf_counter()
        run(cfg)
        if device == "cuda":
            import torch

            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    return wall, _load(os.path.join(out, "metrics.json")), stages


def host_speed() -> float:
    """Seconds of a fixed single-threaded loop: the host's speed beside
    each run, to tell the host's drift from the program's."""
    t = time.perf_counter()
    total = 0
    for i in range(2_000_000):
        total += i * i
    return time.perf_counter() - t


def forbidden_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process, by whole
    top-level name (``duet_tpu_torch`` is not ``duet_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def artifact_digest(out: str) -> str:
    """A digest of a sample's artifacts as the comparison reads them."""
    h = hashlib.sha256()
    for rel, lines in compare.port_artifacts(out):
        h.update(rel.encode())
        for line in lines:
            h.update(line.encode())
    return h.hexdigest()


def read_metrics(names: list[str], run: Run) -> dict:
    """Each metric's value from its reader; a reader that finds nothing to
    read leaves its metric out."""
    out = {}
    for name in names:
        mod = importlib.import_module(f"h100_bench.metrics.{name}")
        value = mod.read(run)
        if value is not None:
            out[name] = {"value": value, "unit": mod.UNIT}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t0: float | None = None,
             work_root: str | None = None) -> dict:
    """One run of `cell`; returns the result line's object.  `device`
    'cpu' (the CPU tests) skips the look for cards."""
    t0 = time.perf_counter() if t0 is None else t0
    card = device == "cuda"
    work = tempfile.mkdtemp(prefix="h100_bench-", dir=work_root)
    try:
        return _run(cell, seed, seconds, traced, device, card, t0, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(cell, seed, seconds, traced, device, card, t0, work) -> dict:
    cards, datas = prepare(cell, seed, work, card)
    if card and (not cards["cuda"] or cards["count"] < cell.chips):
        raise SystemExit(f"cell {cell.name} needs {cell.chips} card(s); "
                         f"torch sees {cards}")
    run = Run()
    run.cold_s, run.cold_metrics, _ = sample(
        cell, datas[0], os.path.join(work, "cold"), device, run.cold_peaks)
    # a warm-up sample on every input but the cold one's, or on that one
    for k, data in enumerate(datas[1:] or datas):
        sample(cell, data, os.path.join(work, f"warm{k}"), device)
    print(f"[cold] {run.cold_s} s, backends "
          + json.dumps(run.cold_metrics["backends"]),
          file=sys.stderr, flush=True)

    host_before = host_speed()
    window_start = time.perf_counter()
    run.setup_s = window_start - t0
    outs = []
    while time.perf_counter() - window_start < seconds:
        out = os.path.join(work, f"s{len(outs)}")
        wall, metrics, stages = sample(
            cell, datas[len(outs) % len(datas)], out, device)
        outs.append(out)
        run.sample_s.append(wall)
        run.sample_metrics.append(metrics)
        run.sample_stages.append(stages)
    run.window_s = time.perf_counter() - window_start
    print(f"[host] fixed loop seconds before / after the window: "
          f"{host_before} / {host_speed()}", file=sys.stderr, flush=True)
    run.peak_host_mb = clock.peak_mb()
    if traced:
        run.trace = trace.traced_samples(
            lambda k: sample(cell, datas[k % len(datas)],
                             os.path.join(work, f"t{k}"), device),
            TRACED_SAMPLES, os.path.join(work, "trace.json"))
        if card and run.trace.busy_s <= 0:
            raise SystemExit("the traced samples ran no operation on the "
                             "card")
    routes = [json.dumps(m["backends"]) for m in run.sample_metrics]
    for route in sorted(set(routes)):
        print(f"[window] {routes.count(route)} sample(s) with backends "
              + route, file=sys.stderr, flush=True)
    print("[window] sample seconds " + json.dumps(run.sample_s),
          file=sys.stderr, flush=True)

    device_info = _device_info(cell, card, run)
    leaked = forbidden_modules()
    if leaked:
        raise SystemExit(f"modules of JAX or duet_tpu loaded: {leaked}")
    gc.collect()
    if card:
        import torch

        torch.cuda.empty_cache()

    # each input's first sample against the reference, the inputs' in
    # parallel processes; every later sample of an input against its first
    firsts = outs[:len(datas)]
    with ProcessPoolExecutor(len(firsts),
                             mp_context=get_context("spawn")) as pool:
        judged = list(pool.map(
            compare.check_sample, firsts, datas[:len(firsts)],
            [os.path.join(work, f"ref{i}") for i in range(len(firsts))],
            [compare.reference_flags(cell.traffic["pipeline"])]
            * len(firsts),
            [cell.limits] * len(firsts)))
    for i, c in enumerate(judged):
        print(f"[input {i}] " + json.dumps(
            {name: n["value"] for name, n in c.items()}),
            file=sys.stderr, flush=True)
    checks = {}     # each number at its worst over the inputs
    for c in judged:
        for name, n in c.items():
            if name not in checks or n["value"] > checks[name]["value"]:
                checks[name] = dict(n)
    judged_ok = [all(n["value"] <= n["limit"] for n in c.values())
                 for c in judged]
    digests = [artifact_digest(o) for o in outs]
    unlike = [digests[k] != digests[k % len(firsts)]
              for k in range(len(outs))]
    failed = sum(1 for k in range(len(outs))
                 if unlike[k] or not judged_ok[k % len(firsts)])
    checks["samples_unlike_first"] = {"value": sum(unlike), "limit": 0}
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    names = cell.per_layer if traced else cell.end_to_end
    result = {
        "correct": failed == 0 and bool(outs),
        "attempted": len(outs),
        "failed": failed,
        "metrics": read_metrics(names, run),
        "device": device_info,
    }
    if traced:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return result


def _device_info(cell: Cell, card: bool, run: Run) -> dict:
    info = {"platform": "cpu", "kind": "cpu", "count": 0,
            "memory_peak_bytes": 0}
    if card:
        import torch

        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": cell.chips,
                "memory_peak_bytes": max(
                    torch.cuda.max_memory_allocated(d)
                    for d in range(cell.chips))}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return info
