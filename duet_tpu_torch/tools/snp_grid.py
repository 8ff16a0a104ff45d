"""``duet_tpu.tools.snp_grid``, copied for the port: verbatim but for its
imports and the neural caller's device: ``run_cell`` runs the port's
``nn_call_snps`` on `device`, and ``--device cuda|cpu`` (default cuda) picks
it.

Head-to-head: counting SNP caller vs the neural pileup caller.

Runs both callers on simulated data over a coverage x error grid (seeds
disjoint from the NN's training seeds) and reports site-level P/R/F1 plus
genotype accuracy on true positives — the evidence for when `--snp-model
nn` earns its keep (Clair3's raison d'etre is low coverage, reference
snp_calling.py:13-17).

    python -m duet_tpu_torch.tools.snp_grid [--quick] [--device cuda|cpu]

Prints one JSON document; README.md carries the captured table.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch


def score(snps, truth_pos, truth_alt, truth_gt):
    """Site-level precision/recall/F1 (position+alt match) and genotype
    (het/hom) accuracy on the true positives."""
    order = np.argsort(truth_pos)
    tp_pos, tp_alt = truth_pos[order], truth_alt[order]
    tp_hom = truth_gt[order].sum(axis=1) >= 2
    j = np.searchsorted(tp_pos, snps.pos)
    ok = j < len(tp_pos)
    jc = np.minimum(j, max(len(tp_pos) - 1, 0))
    hit = ok & (tp_pos[jc] == snps.pos) & (tp_alt[jc] == snps.alt_code) \
        if len(tp_pos) else np.zeros(len(snps.pos), bool)
    tp = int(hit.sum())
    p = tp / max(len(snps.pos), 1)
    r = tp / max(len(tp_pos), 1)
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    gt_ok = int((~snps.is_het[hit] == tp_hom[jc[hit]]).sum())
    return {
        "called": len(snps.pos), "truth": len(tp_pos), "tp": tp,
        "precision": round(p, 4), "recall": round(r, 4), "f1": round(f1, 4),
        "gt_acc": round(gt_ok / max(tp, 1), 4),
    }


def run_cell(coverage: float, sub_error: float, seed: int,
             device: torch.device = torch.device("cuda")) -> dict:
    from duet_tpu_torch.io.fasta import FastaFile
    from duet_tpu_torch.io.readstore import load_read_store
    from duet_tpu_torch.models.nn_snp import nn_call_snps
    from duet_tpu_torch.models.snp_caller_host import (
        SnpCallConfig,
        call_snps,
        count_alleles,
        pileup_observations,
    )
    from duet_tpu_torch.sim.simulate import SimConfig, simulate_dataset

    tmp = tempfile.mkdtemp(prefix="snp_grid_")
    try:
        sim = SimConfig(contigs={"chrG": 250_000}, seed=seed,
                        coverage=coverage, sub_error=sub_error,
                        sv_count_per_mb=0.0)
        truth = simulate_dataset(tmp, sim)
        store = load_read_store(os.path.join(tmp, "reads.bam"))
        codes = FastaFile(os.path.join(tmp, "ref.fa")).fetch_codes("chrG")
        cr = store.contigs["chrG"]
        cfg = SnpCallConfig()
        obs = pileup_observations(cr, cfg)
        counts = count_alleles(obs[0], obs[1], obs[2], len(codes),
                               cfg.min_base_qual)
        res_counts = call_snps("chrG", counts, codes, cfg)
        res_nn = nn_call_snps("chrG", counts, codes, device=device)
        t = (truth.snp_pos["chrG"], truth.snp_alt["chrG"],
             truth.snp_gt["chrG"])
        return {"counts": score(res_counts, *t), "nn": score(res_nn, *t)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    from duet_tpu_torch.device import require, resolve

    argv = sys.argv[1:] if argv is None else argv
    quick = "--quick" in argv
    device = require(resolve(argv[argv.index("--device") + 1]
                             if "--device" in argv else "cuda"))
    coverages = (6.0, 10.0) if quick else (5.0, 6.0, 8.0, 12.0, 20.0)
    errors = (0.02,) if quick else (0.02, 0.05)
    seeds = (101,) if quick else (101, 102, 103)
    grid = []
    for cov in coverages:
        for err in errors:
            cells = [run_cell(cov, err, s, device) for s in seeds]
            agg = {}
            for model in ("counts", "nn"):
                agg[model] = {
                    k: round(float(np.mean([c[model][k] for c in cells])), 4)
                    for k in ("precision", "recall", "f1", "gt_acc")
                }
            grid.append({"coverage": cov, "sub_error": err, **agg,
                         "winner": "nn" if agg["nn"]["f1"] > agg["counts"]["f1"]
                         else ("counts" if agg["counts"]["f1"] > agg["nn"]["f1"]
                               else "tie")})
    print(json.dumps({"seeds": seeds, "grid": grid}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
