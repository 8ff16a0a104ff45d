"""Where each of ``--device-stages auto``'s size gates lies on this device.

Run as ``python -m duet_tpu_torch.route_crossover [--device cuda|cpu]
[--quick] [--stages phasing,sv,decide,pileup] [--sizes STAGE=N,N,...]``.
For each gated stage it runs the host route and the device route on the
same input at several sizes, asserts that their outputs are equal, and
times each route after a first call: REPS times in turns (host, device,
device, host, ...), with the device synchronised before every clock read;
a row holds each route's median, the range of its timed calls and its
first call.  It prints one JSON row per size and, last, one JSON object
with the card, every row and the derived gates.

The device route wins at a size when its slowest timed call beat the host
route's fastest, so a margin inside the spread between calls is no win.
A stage's gate is the smallest size measured from which the device route
won at every larger size measured, or null where it won at none: auto
then keeps the stage on the host.  The phasing stage is timed with both
device scorers; its gate is the faster scorer's, and that scorer is the
one ``HAPLOTAG_DEVICE_MODE`` names.  ``pipeline.PipelineConfig``'s
``*_H100_*`` constants and the scorer are set from this output on the
card.

The stages and their size axes:

  phasing  refine (2 sweeps) and read scoring of one contig, against its
           allele-matrix entries (nnz), on tools.haplotag_crossover's
           synthetic matrices; the device with the sparse and the dense
           scorer
  sv       SV clustering (every type in one pass) of one contig's
           signatures, against their count K
  decide   the SV decision pass of one chromosome, against its calls
  pileup   SNP calling (the counting rule) of a two-contig store simulated
           at 20x, against its read bases: the native host count against
           the device pileup, on the whole store as a batch run counts it
           ("pileup") and on its first contig alone as --stream counts
           each contig ("pileup_contig")

The SV signatures and the callset are real-shaped: a contig simulated as
the smoke simulates its own (seed 11, 20x; BASE_LENGTH bases), its CIGAR
and split-read signatures as the SV caller extracts them, and the SV
callset and read haplotags of the host pipeline's run on it.  A size past
the contig's own repeats it along the chromosome: each copy shifted by
the contig's length, with reads (and phase sets) of its own.

--quick runs two small sizes a stage on a smaller contig (a CPU check of
the routes' equality, not a measurement); --sizes replaces one stage's
sizes (pileup sizes are the store's genome length in bases).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

STAGES = ("phasing", "sv", "decide", "pileup")
SIZES = {
    "phasing": [2_000, 5_000, 10_000, 25_000, 50_000, 100_000, 200_000,
                400_000, 800_000],
    "sv": [1_000, 2_000, 4_000, 8_000, 16_000, 32_000, 64_000, 256_000],
    "decide": [250, 1_000, 2_000, 4_000, 8_000, 16_000, 64_000],
    "pileup": [250_000, 500_000, 1_000_000, 2_000_000, 4_000_000],
}
QUICK = {"phasing": [5_000, 20_000], "sv": [500, 2_000],
         "decide": [100, 400], "pileup": [40_000, 80_000]}
BASE_LENGTH = 2_000_000       # the simulated contig of the sv and decide rows
QUICK_BASE_LENGTH = 150_000
COVERAGE = 20.0
REPS = 5   # timed calls of each route after its first, in turns
# the keys of each stage's gate in metrics.json's device_size_gates
GATE_KEYS = {"phasing": "phasing_min_nnz", "sv": "sv_cluster_min_signatures",
             "decide": "decide_min_calls", "pileup": "pileup_min_bases",
             "pileup_contig": "pileup_contig_min_bases"}


def _clock(device: torch.device) -> float:
    from duet_tpu_torch.device import synchronize

    synchronize(device)
    return time.perf_counter()


def _timed(routes: dict, device: torch.device) -> dict:
    """name -> (result, first call's seconds, the REPS later calls'
    seconds), the routes timed in turns: in order, then reversed."""
    def clocked(fn):
        t0 = _clock(device)
        out = fn()
        return out, _clock(device) - t0

    first = {name: clocked(fn) for name, fn in routes.items()}
    times: dict = {name: [] for name in routes}
    out = {}
    for rep in range(REPS):
        order = list(routes) if rep % 2 == 0 else list(routes)[::-1]
        for name in order:
            out[name], dt = clocked(routes[name])
            times[name].append(dt)
    return {name: (out[name], first[name][1], times[name]) for name in routes}


def _route(row: dict, name: str, times: list[float],
           first: float | None = None) -> None:
    """`name`'s median, range and first call into `row`."""
    row[f"{name}_s"] = float(np.median(times))
    row[f"{name}_range"] = [min(times), max(times)]
    if first is not None:
        row[f"{name}_first_s"] = first


def _equal(a, b, what: str) -> None:
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(x, y, err_msg=what)


def phasing_row(nnz: int, device: torch.device) -> dict:
    """Refine + scoring of one synthetic contig of `nnz` entries."""
    from duet_tpu_torch.models.snp_phaser import _haplotag_device
    from duet_tpu_torch.models.snp_phaser_host import _haplotag, _power_refine
    from duet_tpu_torch.ops.sparse_power import power_refine_device
    from duet_tpu_torch.tools.haplotag_crossover import make_problem

    am, phase, block_id, block_ps = make_problem(nnz)

    def host():
        ph = _power_refine(am, phase, block_id, 2)
        return (ph, *_haplotag(am, ph, block_id, block_ps))

    def on_device(mode: str):
        def run():
            ph = power_refine_device(am, phase, block_id, 2, device)
            return (ph, *_haplotag_device(am, ph, block_id, block_ps,
                                          mode=mode, device=device))
        return run

    t = _timed({"host": host, "sparse": on_device("sparse"),
                "dense": on_device("dense")}, device)
    want = t["host"][0]
    row = {"stage": "phasing", "size": len(am.row), "reads": am.n_reads,
           "sites": am.n_sites}
    _route(row, "host", t["host"][2])
    for mode in ("sparse", "dense"):
        got, first, times = t[mode]
        _equal(got, want, f"phasing {mode} at {nnz}")
        _route(row, mode, times, first)
    return row


@dataclasses.dataclass
class Base:
    """A simulated contig and what the host pipeline made of it."""
    length: int                 # the contig's bases
    n_reads: int                # its alignments in the store
    signatures: tuple           # (svtype, pos, length, read_idx)
    records: list               # its SV calls (io.vcf.SVRecord)
    read_hap: dict              # read name -> (hap, ps, pc), the calls' reads


def make_base(work: str, length: int) -> Base:
    """Simulate one contig of `length` bases as the smoke simulates its own
    (seed 11, 20x), take its SV signatures as the SV caller extracts them,
    and run the pipeline on the host (--device-stages off) for its SV
    callset and read haplotags."""
    from duet_tpu_torch.io.haplotag_bam import read_hap_tables_from_dir
    from duet_tpu_torch.io.native_ingest import load_read_store_native
    from duet_tpu_torch.io.vcf import parse_sv_vcf
    from duet_tpu_torch.models.sv_caller_host import (
        SvCallConfig,
        contig_tables,
        extract_signatures,
        extract_split_signatures,
    )
    from duet_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from duet_tpu_torch.sim import SimConfig, simulate_dataset

    data, out = os.path.join(work, "base"), os.path.join(work, "base_off")
    simulate_dataset(data, SimConfig(contigs={"chr1": length},
                                     coverage=COVERAGE, seed=11))
    bam = os.path.join(data, "reads.bam")
    run_pipeline(PipelineConfig(bam=bam, reference=os.path.join(data,
                                                                "ref.fa"),
                                output=out, device="cpu",
                                device_stages="off"))
    cr = load_read_store_native(bam).contigs["chr1"]
    cfg = SvCallConfig()
    cig = extract_signatures(cr, cfg)
    spl = extract_split_signatures(cr, cfg, contig_tables(cr, cfg))
    sigs = tuple(np.concatenate([getattr(cig, f), getattr(spl, f)])
                 for f in ("svtype", "pos", "length", "read_idx"))
    per_chrom = parse_sv_vcf(os.path.join(out, "sv_calling", "variants.vcf"),
                             False)
    (chrom, records), = ((c, r) for c, r in per_chrom.items() if r)
    haps = read_hap_tables_from_dir(os.path.join(out, "snp_phasing"),
                                    [chrom])[chrom]
    names = {n for r in records for n in r.read_names}
    if not records or not len(sigs[0]):
        raise AssertionError(f"the {length}-base contig has no SV call")
    return Base(length, cr.n, sigs, records,
                {n: h for n, h in haps.items() if n in names})


def tile_signatures(base: Base, k: int):
    """(svtype, pos, length, read_idx) of `k` signatures: the base contig's,
    repeated along the chromosome until there are `k`."""
    svtype, pos, length, read_idx = base.signatures
    n = len(pos)
    copy = np.arange(k) // n
    idx = np.arange(k) % n
    return (svtype[idx].astype(np.int32), pos[idx] + copy * base.length,
            length[idx], read_idx[idx] + copy * base.n_reads)


def tile_callset(base: Base, n_calls: int):
    """(records, read_hap) of one chromosome of `n_calls` calls: the base
    contig's callset repeated along the chromosome, each copy's reads and
    phase sets its own."""
    records, read_hap = [], {}
    for copy in range(-(-n_calls // len(base.records))):
        shift = copy * base.length
        for r in base.records[:n_calls - len(records)]:
            records.append(dataclasses.replace(
                r, pos=r.pos + shift, call_id=f"{r.call_id}/{copy}",
                read_names=[f"{n}/{copy}" for n in r.read_names],
                read_haps=[]))
        for n, (hap, ps, pc) in base.read_hap.items():
            read_hap[f"{n}/{copy}"] = (hap, ps + shift, pc)
    return records, read_hap


def sv_row(k: int, device: torch.device, base: Base) -> dict:
    """One pass of every type's clustering at the pipeline's defaults."""
    from duet_tpu_torch.models.sv_caller_host import (
        SvCallConfig,
        cmd_as_rational,
    )
    from duet_tpu_torch.ops.cluster import GAP, cluster_multi

    cfg = SvCallConfig()
    num, den = cmd_as_rational(cfg.cluster_max_distance)
    md = (cfg.max_dist_ins, cfg.max_dist_del, cfg.max_dist_del,
          cfg.max_dist_del)
    args = (*tile_signatures(base, k), GAP, md, num, den)
    return _host_device_row("sv", k, {
        "host": lambda: cluster_multi(*args, device=False),
        "device": lambda: cluster_multi(*args, device=True,
                                        torch_device=device)},
        device, lambda got, want: _equal(got, want, f"sv at {k}"))


def _host_device_row(stage: str, size: int, routes: dict,
                     device: torch.device, check) -> dict:
    """A row of a stage with one device route: `check(device's result,
    host's result)` raises where they differ."""
    t = _timed(routes, device)
    check(t["device"][0], t["host"][0])
    row = {"stage": stage, "size": size}
    _route(row, "host", t["host"][2])
    _route(row, "device", t["device"][2], t["device"][1])
    return row


def decide_row(n_calls: int, device: torch.device, base: Base) -> dict:
    """phase_chromosome at the pipeline's defaults, host against device."""
    from duet_tpu_torch.models.sv_phaser import phase_chromosome

    records, read_hap = tile_callset(base, n_calls)
    phased = []

    def run(use_device: bool):
        return lambda: phase_chromosome(records, read_hap, 50, 2,
                                        use_device=use_device, device=device)

    def check(got, want):
        if got != want:
            raise AssertionError(f"decide at {n_calls}: the routes differ")
        phased.append(len(want))

    row = _host_device_row("decide", n_calls, {"host": run(False),
                                               "device": run(True)},
                           device, check)
    return {**row, "phased": phased[0]}


def pileup_rows(length: int, device: torch.device, work: str,
                threads: int = 4) -> list[dict]:
    """SNP calling of a simulated two-contig store of `length` bases in all
    (seed 7, 20x), host against device: the store through
    ``call_snps_for_store`` (a batch run's shape), and its first contig
    alone through ``call_contig_snps`` (--stream's)."""
    from duet_tpu_torch.io.fasta import FastaFile
    from duet_tpu_torch.io.native_ingest import load_read_store_native
    from duet_tpu_torch.models.snp_caller import (
        call_contig_snps,
        call_snps_for_store,
    )
    from duet_tpu_torch.models.snp_caller_host import SnpCallConfig
    from duet_tpu_torch.sim import SimConfig, simulate_dataset

    data = os.path.join(work, f"pileup_{length}")
    half = length // 2
    t = time.perf_counter()
    simulate_dataset(data, SimConfig(contigs={"chr1": half,
                                              "chr2": length - half},
                                     coverage=COVERAGE, seed=7))
    sim_s = time.perf_counter() - t
    store = load_read_store_native(os.path.join(data, "reads.bam"),
                                   n_threads=threads)
    fa = FastaFile(os.path.join(data, "ref.fa"))
    codes = {c: fa.fetch_codes(c) for c in store.contigs}
    cfgs = {False: SnpCallConfig(device=False),
            True: SnpCallConfig(device=True)}

    def run(on_device: bool):
        return lambda: call_snps_for_store(store, codes, cfgs[on_device],
                                           threads=threads, device=device)

    def run_contig(on_device: bool):
        cr = store.contigs["chr1"]
        return lambda: tuple({"chr1": x} for x in call_contig_snps(
            "chr1", cr, codes["chr1"], cfgs[on_device], device=device))

    def check(got, want):
        if list(got[0]) != list(want[0]):
            raise AssertionError(f"pileup at {length}: other contigs")
        for c in want[0]:
            w, g = want[0][c], got[0][c]
            _equal([g.pos, g.ref_code, g.alt_code, g.is_het, g.depth,
                    g.alt_count], [w.pos, w.ref_code, w.alt_code, w.is_het,
                                   w.depth, w.alt_count], f"pileup {c}")
            _equal(got[1][c], want[1][c], f"pileup obs {c}")

    n_bases = int(sum(len(cr.seq) for cr in store.contigs.values()))
    rows = [
        _host_device_row("pileup", n_bases, {"host": run(False),
                                             "device": run(True)},
                         device, check),
        _host_device_row("pileup_contig", len(store.contigs["chr1"].seq),
                         {"host": run_contig(False),
                          "device": run_contig(True)}, device, check)]
    shutil.rmtree(data, ignore_errors=True)
    return [{**row, "length": length, "sim_s": sim_s} for row in rows]


def derive_gate(rows: list[dict], key: str = "device") -> int | None:
    """The smallest size from which `key`'s route won at every larger size
    measured (its slowest timed call beat the host's fastest); None if it
    won at none."""
    gate = None
    for row in sorted(rows, key=lambda r: r["size"], reverse=True):
        if row[f"{key}_range"][1] >= row["host_range"][0]:
            break
        gate = row["size"]
    return gate


def derive_gates(rows: list[dict]) -> dict:
    """Every stage's gate, and the phasing scorer: the scorer with the
    lower gate, or on a tie the one faster over the sizes past it."""
    out: dict = {}
    by: dict = {}
    for r in rows:
        by.setdefault(r["stage"], []).append(r)
    if "phasing" in by:
        modes = {m: derive_gate(by["phasing"], m) for m in ("sparse", "dense")}

        def rank(m):
            g = modes[m]
            past = sum(r[f"{m}_s"] for r in by["phasing"]
                       if g is not None and r["size"] >= g)
            return (g is None, g or 0, past)
        mode = min(modes, key=rank)
        out["haplotag_mode"] = mode
        out[GATE_KEYS["phasing"]] = modes[mode]
    for s in ("sv", "decide", "pileup", "pileup_contig"):
        if s in by:
            out[GATE_KEYS[s]] = derive_gate(by[s])
    return out


def _card() -> str | None:
    import subprocess

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return None
    return smi.stdout.strip().splitlines()[0]


def main(argv: list[str] | None = None) -> int:
    from duet_tpu_torch.device import require, resolve

    p = argparse.ArgumentParser(
        prog="python -m duet_tpu_torch.route_crossover")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--stages", default=",".join(STAGES))
    p.add_argument("--sizes", action="append", default=[],
                   metavar="STAGE=N,N,...")
    args = p.parse_args(argv)
    device = require(resolve(args.device))
    stages = args.stages.split(",")
    sizes = dict(QUICK if args.quick else SIZES)
    for spec in args.sizes:
        stage, _, ns = spec.partition("=")
        sizes[stage] = [int(n) for n in ns.split(",")]
    for s in stages:
        if s not in STAGES:
            raise SystemExit(f"unknown stage {s!r}; stages are {STAGES}")
    rows = []
    work = tempfile.mkdtemp(prefix="duet_route_crossover_")
    try:
        base = None
        if {"sv", "decide"} & set(stages):
            base = make_base(work, QUICK_BASE_LENGTH if args.quick
                             else BASE_LENGTH)
        for stage in stages:
            for n in sizes[stage]:
                if stage == "phasing":
                    new = [phasing_row(n, device)]
                elif stage == "pileup":
                    new = pileup_rows(n, device, work)
                else:
                    measure = {"sv": sv_row, "decide": decide_row}[stage]
                    new = [measure(n, device, base)]
                for row in new:
                    rows.append(row)
                    print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"device": str(device),
                      "card": _card() if device.type == "cuda" else None,
                      "gates": derive_gates(rows), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
