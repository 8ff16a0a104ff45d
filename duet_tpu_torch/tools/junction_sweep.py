"""``duet_tpu.tools.junction_sweep``, copied for the port: verbatim but for its
imports and the module it patches.  ``ADAPTIVE_N1`` is read by
``models/snp_phaser_host.py``'s ``_split_weak_junctions``, so the sweep sets
it there.

End-to-end junction-splitting rule comparison (VERDICT r2 #4).

Runs the full pipeline + evaluation across coverages x seeds for each
weak-junction splitting rule and reports mean calling / genotyping /
phasing F1 per (coverage, rule) — the measurement that decides the
default (the adaptive rule must gain phasing >= +0.03 at >=10x with no
8x regression; docs/PC_SCALE.md carries the captured table).

Rules:
  off        no splitting (reference-neutral baseline)
  abs2000    --min-junction-evidence 2000 (round-2 documented setting)
  adaptive   coverage-relative outlier + disagreement/single-read guard
             (models/snp_phaser.py ADAPTIVE_*)
  adaptive_noN1  same without the single-read guard (ablation)

    python -m duet_tpu_torch.tools.junction_sweep [--quick]
        [--coverages 8,10,12] [--seeds 70,...] [--mb 0.25]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np


RULES = ("off", "abs2000", "adaptive", "adaptive_noN1")


def run_rule(data_dir: str, rule: str, out: str) -> dict:
    from duet_tpu_torch.eval.evaluate import evaluate_files
    from duet_tpu_torch.models import snp_phaser_host
    from duet_tpu_torch.pipeline import PipelineConfig, run_pipeline

    kw = dict(min_junction_evidence=0.0, adaptive_junction_split=False)
    if rule == "abs2000":
        kw["min_junction_evidence"] = 2000.0
    elif rule in ("adaptive", "adaptive_noN1"):
        kw["adaptive_junction_split"] = True
    old_n1 = snp_phaser_host.ADAPTIVE_N1
    snp_phaser_host.ADAPTIVE_N1 = rule != "adaptive_noN1"
    try:
        run_pipeline(PipelineConfig(
            bam=os.path.join(data_dir, "reads.bam"),
            reference=os.path.join(data_dir, "ref.fa"),
            output=out, use_device_kernel=False, **kw))
    finally:
        snp_phaser_host.ADAPTIVE_N1 = old_n1
    res = evaluate_files(os.path.join(out, "phased_sv.vcf"),
                         os.path.join(data_dir, "truth.vcf"))
    s = res.summary()
    return {"calling": s["calling"]["f1"], "genotyping": s["genotyping"]["f1"],
            "phasing": s["phasing"]["f1"]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv

    def opt(name, default):
        return argv[argv.index(name) + 1] if name in argv else default

    quick = "--quick" in argv
    coverages = [float(c) for c in opt(
        "--coverages", "8,10" if quick else "8,10,12").split(",")]
    seeds = [int(s) for s in opt(
        "--seeds", "70,71" if quick else "70,71,72,73,74,75,76,77").split(",")]
    mb = float(opt("--mb", "0.25"))
    # --rules trims the sweep for expensive (genome-scale --mb) re-checks
    rules = tuple(opt("--rules", ",".join(RULES)).split(","))
    for r in rules:
        if r not in RULES:
            raise SystemExit(f"unknown rule {r!r}; choose from {RULES}")
    from duet_tpu_torch.sim.simulate import SimConfig, simulate_dataset

    cells: dict[tuple, list[dict]] = {}
    for seed in seeds:
        for cov in coverages:
            with tempfile.TemporaryDirectory(prefix="jsweep_") as data:
                simulate_dataset(data, SimConfig(
                    contigs={"chr21": int(mb * 1e6)}, seed=seed,
                    coverage=cov))
                for rule in rules:
                    with tempfile.TemporaryDirectory(prefix="jrun_") as out:
                        cells.setdefault((cov, rule), []).append(
                            run_rule(data, rule, out))
    table = {}
    for (cov, rule), rows in sorted(cells.items()):
        table.setdefault(str(cov), {})[rule] = {
            k: round(float(np.mean([r[k] for r in rows])), 4)
            for k in ("calling", "genotyping", "phasing")
        }
    print(json.dumps({"seeds": seeds, "mb": mb, "table": table}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
