"""``duet_tpu.tools.junction_diag``, copied for the port: verbatim but for its
imports.

Truth-labeled junction diagnostics (VERDICT r2 #4).

Weak-junction splitting needs a discriminator that separates REAL switch
errors (split here: phasing precision up) from genuinely weak but CORRECT
junctions (splitting costs calling recall through the two-phase-set
decision regime, reference sv_phasing_fn.py:120-158).  The absolute
`--min-junction-evidence` threshold cannot: a wrong 10x junction (E~2000)
and a correct single-read 8x junction (E~1600) overlap (docs/PC_SCALE.md).

This tool runs the phasing internals on simulated data where the true
per-site phase is KNOWN (sim snp_gt), labels every converged block junction
as switch / correct, and dumps per-junction features:

  E  signed spanning evidence (corrector objective)
  M  total spanning magnitude sum |L||R| (coverage-scaled ceiling of E)
  N  spanning read count
  rho = E/M  agreement ratio in [-1, 1] (coverage-free)
  med_E, med_M  block medians (local coverage scale)

    python -m duet_tpu_torch.tools.junction_diag [--coverages 8,10,12]
        [--seeds 41,42,43] [--mb 0.25]

Prints one JSON document: rows plus a separation summary per candidate
rule; docs/PC_SCALE.md carries the captured analysis.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np


def converge_phase(am):
    """The host phasing loop exactly as phase_contig runs it (initial chain
    phase -> alternating majority refinement / suffix-flip correction)."""
    from duet_tpu_torch.models.snp_phaser_host import (
        _initial_phase, _power_refine, _switch_correct)

    phase, block_id, block_ps = _initial_phase(am)
    phase = _power_refine(am, phase, block_id, 2)
    for _ in range(4):
        corrected = _switch_correct(am, phase, block_id)
        changed = bool(np.any(corrected != phase))
        phase = _power_refine(am, corrected, block_id, 2)
        if not changed:
            break
    return phase, block_id, block_ps


def junction_rows(data_dir: str, truth, coverage: float, seed: int):
    """Per-junction feature+label rows for one simulated dataset."""
    from duet_tpu_torch.io.fasta import FastaFile
    from duet_tpu_torch.io.readstore import load_read_store
    from duet_tpu_torch.models.snp_caller import call_snps_for_store
    from duet_tpu_torch.models.snp_caller_host import SnpCallConfig
    from duet_tpu_torch.models.snp_phaser_host import (
        _junction_evidence, build_allele_matrix)

    store = load_read_store(os.path.join(data_dir, "reads.bam"))
    fa = FastaFile(os.path.join(data_dir, "ref.fa"))
    ref_codes = {c: fa.fetch_codes(c) for c in store.contigs}
    cfg = SnpCallConfig()
    snps_all, obs_all = call_snps_for_store(store, ref_codes, cfg)

    rows = []
    for contig, snps in snps_all.items():
        am = build_allele_matrix(store.contigs[contig], snps, cfg,
                                 obs=obs_all.get(contig))
        if am.n_sites < 2:
            continue
        phase, block_id, _ = converge_phase(am)
        # truth phase per called het site: +1 alt-on-hap0, -1 alt-on-hap1,
        # 0 for sites absent from the truth set (false het calls)
        tpos = truth.snp_pos[contig]
        tgt = truth.snp_gt[contig]
        t_isphased = tgt.sum(axis=1) == 1
        tphase = np.where(tgt[:, 0] == 1, 1, -1) * t_isphased
        j = np.searchsorted(tpos, am.site_pos)
        jc = np.minimum(j, len(tpos) - 1) if len(tpos) else j * 0
        has_truth = (j < len(tpos)) & (tpos[jc] == am.site_pos) \
            if len(tpos) else np.zeros(am.n_sites, bool)
        site_truth = np.zeros(am.n_sites, dtype=np.int8)
        site_truth[has_truth] = tphase[jc[has_truth]]
        agree = phase * site_truth  # +1/-1 where both defined, else 0

        for b, (cols_b, E, M, N) in _junction_evidence(
                am, phase, block_id).items():
            if len(E) == 0:
                continue
            a = agree[cols_b]
            med_E = float(np.median(E))
            med_M = float(np.median(M))
            # per boundary i (between cols_b[i] and cols_b[i+1]): nearest
            # labeled site on each side; switch iff their agreement differs
            for i in range(len(E)):
                left = a[: i + 1][a[: i + 1] != 0]
                right = a[i + 1:][a[i + 1:] != 0]
                if len(left) == 0 or len(right) == 0:
                    continue
                rows.append({
                    "coverage": coverage, "seed": seed, "contig": contig,
                    "block": int(b), "boundary_site": int(cols_b[i]),
                    "E": float(E[i]), "M": float(M[i]), "N": float(N[i]),
                    "rho": float(E[i] / M[i]) if M[i] > 0 else 1.0,
                    "med_E": med_E, "med_M": med_M,
                    "switch": bool(left[-1] != right[0]),
                })
    return rows


CANDIDATE_RULES = {
    # name -> predicate(row) deciding "split here"
    "abs2000": lambda r: r["E"] < 2000,
    "med20": lambda r: r["E"] < min(2000.0, r["med_E"] / 20.0),
    "rho.5": lambda r: r["rho"] < 0.5,
    "rho.5_or_relM": lambda r: r["rho"] < 0.5 or r["E"] < r["med_M"] / 50.0,
    "relM50": lambda r: r["E"] < r["med_M"] / 50.0,
    "relM20": lambda r: r["E"] < r["med_M"] / 20.0,
    "relE20": lambda r: r["E"] < r["med_E"] / 20.0,
    "N1_high_cov": lambda r: r["N"] <= 1.5 and r["med_M"] / max(r["M"], 1) > 6,
}


def summarize(rows):
    out = {}
    for name, rule in CANDIDATE_RULES.items():
        per_cov = {}
        for cov in sorted({r["coverage"] for r in rows}):
            sub = [r for r in rows if r["coverage"] == cov]
            sw = [r for r in sub if r["switch"]]
            ok = [r for r in sub if not r["switch"]]
            per_cov[cov] = {
                "junctions": len(sub), "switches": len(sw),
                "caught": sum(rule(r) for r in sw),
                "false_splits": sum(rule(r) for r in ok),
            }
        out[name] = per_cov
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv

    def opt(name, default):
        return argv[argv.index(name) + 1] if name in argv else default

    coverages = [float(c) for c in opt("--coverages", "8,10,12").split(",")]
    seeds = [int(s) for s in opt("--seeds", "41,42,43").split(",")]
    mb = float(opt("--mb", "0.25"))
    from duet_tpu_torch.sim.simulate import SimConfig, simulate_dataset

    rows = []
    for seed in seeds:
        for cov in coverages:
            with tempfile.TemporaryDirectory(prefix="jdiag_") as data:
                truth = simulate_dataset(data, SimConfig(
                    contigs={"chr21": int(mb * 1e6)}, seed=seed,
                    coverage=cov))
                rows.extend(junction_rows(data, truth, cov, seed))
    switches = [r for r in rows if r["switch"]]
    print(json.dumps({
        "n_junctions": len(rows), "n_switches": len(switches),
        "rules": summarize(rows),
        "switch_rows": switches,
        "weakest_correct": sorted(
            (r for r in rows if not r["switch"]), key=lambda r: r["E"])[:20],
    }, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
