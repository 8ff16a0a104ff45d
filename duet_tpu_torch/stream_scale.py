"""Streaming against batch at chromosome scale.

Run as ``python -m duet_tpu_torch.stream_scale``.  It simulates a dataset
of four contigs of 15 Mb at 20x (seed 5), then runs the port's CLI on it
three times under ``--device-stages`` (``on`` by default): the batch run,
``--stream``, and ``--stream`` on 3 cores, where the stream decodes no
contig ahead (its prefetch needs 4).  Each run is a process of its own,
so that each reports its own peak memory.  It prints one line per run
(wall, ``total_s``, stage seconds, ``peak_rss_mb``, ``stage_peak_rss_mb``,
the ingest backend, the stage backends and auto's gates) and the largest
contig's decoded columns (what the prefetch holds beside the contig in
the stages), checks that the runs wrote byte-identical artifacts, and
prints one JSON object with all of it as the last line.  It fails if the
artifacts differ.

Options: ``--contigs NAME:LENGTH,...`` (another cell: GRCh38's chr20 and
chr21 are ``chr20:64444167,chr21:46709983``), ``--device`` (cuda by
default; cpu runs the same code on the host), ``--device-stages
on|auto|off``, ``--work DIR`` (kept, with the data, for further runs,
which reuse the data it holds and simulate nothing; by default a
temporary directory, removed at the end).
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

FOUR_CONTIGS = ",".join(f"chr{i}:15000000" for i in range(1, 5))
COVERAGE = 20.0
SEED = 5


def _read(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def _artifacts(out: str) -> list[str]:
    return ["snp_calling/pileup.vcf.gz", "sv_calling/variants.vcf",
            "phased_sv.vcf"] + [
        f"snp_phasing/{n}"
        for n in sorted(os.listdir(os.path.join(out, "snp_phasing")))]


def _card() -> str | None:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        return None
    return smi.stdout.strip().splitlines()[0]


# the CLI in a process held to its first N cores
_ON_CORES = ("import os, runpy, sys; "
             "n = int(sys.argv[1]); "
             "os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:n]); "
             "sys.argv = ['duet_tpu_torch', *sys.argv[2:]]; "
             "runpy.run_module('duet_tpu_torch', run_name='__main__')")


def _columns_mb(cr) -> float:
    """A decoded contig's size: its column arrays and read names."""
    arrays = sum(v.nbytes for v in vars(cr).values()
                 if isinstance(v, np.ndarray))
    return (arrays + sum(map(sys.getsizeof, cr.names))) / 1e6


def _largest_contig_mb(bam: str) -> float:
    from duet_tpu_torch.io.native_ingest import stream_read_store_native

    return max(_columns_mb(cr) for cr, _ in stream_read_store_native(bam))


def _run(data: str, out: str, device: str, stages: str, *flags: str,
         cores: int | None = None) -> dict:
    args = [os.path.join(data, "reads.bam"), os.path.join(data, "ref.fa"),
            out, "--device", device, "--device-stages", stages, *flags]
    cmd = [sys.executable, "-m", "duet_tpu_torch", *args] if cores is None \
        else [sys.executable, "-c", _ON_CORES, str(cores), *args]
    t = time.perf_counter()
    subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL)
    wall = time.perf_counter() - t
    with open(os.path.join(out, "metrics.json")) as f:
        m = json.load(f)
    ingest = m["ingest_backend"] if "ingest_backend" in m \
        else m["ingest"]["backend"]
    return {"wall_s": wall, "total_s": m["total_s"], "stages": m["stages"],
            "peak_rss_mb": m["peak_rss_mb"],
            "stage_peak_rss_mb": m.get("stage_peak_rss_mb"),
            "ingest": ingest, "reads": m["counts"]["reads"],
            "snp_sites": m["counts"]["snp_sites"],
            "backends": m["backends"],
            "device_size_gates": m.get("device_size_gates"),
            "device_cost_haplotag": m["device_cost"].get("haplotag")}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m duet_tpu_torch.stream_scale")
    p.add_argument("--contigs", default=FOUR_CONTIGS)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--device-stages", default="on",
                   choices=["on", "auto", "off"])
    p.add_argument("--work", default=None)
    args = p.parse_args(argv)

    from duet_tpu_torch.sim import SimConfig, simulate_dataset

    contigs = {name: int(length) for name, length in
               (c.split(":") for c in args.contigs.split(","))}
    work = args.work or tempfile.mkdtemp(prefix="duet_stream_scale_")
    try:
        data = os.path.join(work, "data")
        sim_s = None
        if os.path.exists(os.path.join(data, "reads.bam")):
            print(f"[sim] reusing {data}", flush=True)
        else:
            t = time.perf_counter()
            simulate_dataset(data, SimConfig(contigs=contigs,
                                             coverage=COVERAGE, seed=SEED))
            sim_s = time.perf_counter() - t
            print(f"[sim] {contigs} at {COVERAGE}x (seed {SEED}) in "
                  f"{sim_s:.1f} s", flush=True)
        runs = {}
        for name, flags, cores in (("batch", (), None),
                                   ("stream", ("--stream",), None),
                                   ("stream_no_prefetch", ("--stream",), 3)):
            runs[name] = _run(data, os.path.join(work, name), args.device,
                              args.device_stages, *flags, cores=cores)
            print(f"[{name}] {json.dumps(runs[name])}", flush=True)
        contig_mb = _largest_contig_mb(os.path.join(data, "reads.bam"))
        print(f"[columns] the largest contig decodes to {contig_mb:.1f} MB",
              flush=True)
        batch = os.path.join(work, "batch")
        for other in ("stream", "stream_no_prefetch"):
            other = os.path.join(work, other)
            if _artifacts(batch) != _artifacts(other):
                raise AssertionError(f"{other} wrote other snp_phasing/ "
                                     "files than the batch run")
            for name in _artifacts(batch):
                if _read(os.path.join(batch, name)) != \
                        _read(os.path.join(other, name)):
                    raise AssertionError(f"{name} differs between batch "
                                         f"and {other}")
        print(json.dumps({"card": _card(), "contigs": contigs,
                          "coverage": COVERAGE, "seed": SEED,
                          "device_stages": args.device_stages,
                          "sim_s": sim_s, "identical_artifacts":
                          len(_artifacts(batch)),
                          "largest_contig_columns_mb": contig_mb, **runs}))
    finally:
        if args.work is None:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
