"""``duet_tpu.tools.pc_sweep``, copied for the port: verbatim but for its
imports and the module it patches.  The host scorer that reads
``PC_PER_MARGIN`` is ``models/snp_phaser_host.py``'s ``_haplotag``, so the
sweep sets the constant there (the port's ``models/snp_phaser.py`` has no
such name).

PC-scale sensitivity sweep (VERDICT r1 weak #5).

The framework's phasing confidence is PC = clip(round(PC_PER_MARGIN *
quality-weighted margin), 1, 8100) (models/snp_phaser.py).  The decision
tree's T2/T5 thresholds (hap_avgsc_diff <= 1369.50 / 2400, totsc_ratio <=
9.72 — reference sv_phasing_fn.py:150-177) were tuned on WhatsHap's PC
scale; this sweep reruns the pipeline at several PC_PER_MARGIN values and
reports phasing accuracy plus how many final decisions actually change —
i.e. whether those thresholds are live or dead code on framework PCs.

    python -m duet_tpu_torch.tools.pc_sweep [--quick]

Prints one JSON document; docs/PC_SCALE.md carries the captured result.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile


def run_at_scale(data_dir: str, scale: int, out: str) -> dict:
    from duet_tpu_torch.eval.evaluate import evaluate_files
    from duet_tpu_torch.models import snp_phaser_host
    from duet_tpu_torch.pipeline import PipelineConfig, run_pipeline

    old = snp_phaser_host.PC_PER_MARGIN
    snp_phaser_host.PC_PER_MARGIN = scale
    try:
        # host kernels: PC is produced by the sparse host scorer, so only
        # one constant governs the scale under test
        run_pipeline(PipelineConfig(
            bam=os.path.join(data_dir, "reads.bam"),
            reference=os.path.join(data_dir, "ref.fa"),
            output=out, use_device_kernel=False,
        ))
    finally:
        snp_phaser_host.PC_PER_MARGIN = old
    res = evaluate_files(os.path.join(out, "phased_sv.vcf"),
                         os.path.join(data_dir, "truth.vcf"))
    calls = []
    with open(os.path.join(out, "phased_sv.vcf")) as f:
        for ln in f:
            if ln.startswith("#"):
                continue
            cols = ln.split("\t")
            calls.append((cols[0], cols[1], cols[9].split(":")[0]))
    summary = res.summary()
    return {
        "phasing_f1": summary["phasing"]["f1"],
        "calling_f1": summary["calling"]["f1"],
        "genotyping_f1": summary["genotyping"]["f1"],
        "phased_calls": len(calls),
        "decisions": calls,
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    quick = "--quick" in argv
    scales = (1, 10, 40) if quick else (1, 5, 10, 40, 200)
    seeds = (31,) if quick else (31, 32, 33)
    from duet_tpu_torch.sim.simulate import SimConfig, simulate_dataset

    out_rows = []
    for seed in seeds:
        data = tempfile.mkdtemp(prefix="pc_sweep_")
        try:
            simulate_dataset(data, SimConfig(
                contigs={"chr21": 200_000}, seed=seed, coverage=14.0))
            per_scale = {}
            for scale in scales:
                run = tempfile.mkdtemp(prefix=f"pc_out_{scale}_")
                try:
                    per_scale[scale] = run_at_scale(data, scale, run)
                finally:
                    shutil.rmtree(run, ignore_errors=True)
            base = per_scale[10]["decisions"]
            row = {"seed": seed}
            for scale in scales:
                r = per_scale[scale]
                changed = sum(1 for a, b in zip(base, r["decisions"])
                              if a != b) + abs(len(base) - len(r["decisions"]))
                row[f"scale_{scale}"] = {
                    "phasing_f1": r["phasing_f1"],
                    "calling_f1": r["calling_f1"],
                    "phased_calls": r["phased_calls"],
                    "decisions_changed_vs_scale10": changed,
                }
            out_rows.append(row)
        finally:
            shutil.rmtree(data, ignore_errors=True)
    print(json.dumps({"scales": scales, "rows": out_rows}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
