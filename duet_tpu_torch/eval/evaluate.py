"""``duet_tpu.eval.evaluate``, copied for the port: verbatim but for its
imports.

Evaluation harness: P/R/F1 for SV calling, genotyping, and phasing.

Re-implements the measurement semantics of the reference's standalone scorer
(src/scripts/evaluation.py, SURVEY.md C11) as an importable module + CLI:

* candidate matching: same chrom + SV type, position distance <= refdist
  (default 1000), reciprocal length ratio >= pctsim (default 0)
  (reference evaluation.py:117-127)
* genotype scoring: {1|0, 0|1} form one het equivalence class vs 1|1 hom
  (reference evaluation.py:130-133)
* phasing scoring: orientation-invariant per phase set — each call PS group
  is scored under both polarities and the better one counts
  (reference evaluation.py:111-148)
* filters: chr1-22/X/Y only (unless all_ctgs), |SVLEN| >= 50, genotype
  0|0 / 0/0 dropped (reference evaluation.py:43-96)
* optional BED confinement of both callsets (reference evaluation.py:25-33)
* also reports the average number of SVs per phase set
  (reference evaluation.py:102)
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from duet_tpu_torch.io.vcf import open_maybe_gzip
from duet_tpu_torch.utils.chrom import standard_chrom_names, strip_chr


@dataclass
class EvalEntry:
    chrom: str
    pos: int
    svtype: str
    svlen: int   # absolute
    gt: str      # normalized: '1|0', '0|1', '1|1', or unphased 'het'/'hom'
    ps: str


def _normalize_gt(gt: str) -> str | None:
    """None -> drop the record (absent genotype)."""
    gt = gt.replace("/", "|")
    if gt in ("0|0", ".|.", "."):
        return None
    if gt in ("1|0", "0|1", "1|1"):
        return gt
    if gt == "1|2" or gt == "2|1":
        return "1|1"
    return "het" if "0" in gt else "hom"


def load_eval_vcf(path: str, all_ctgs: bool = False,
                  bed: list[tuple[str, int, int]] | None = None) -> list[EvalEntry]:
    std = set(standard_chrom_names())
    out: list[EvalEntry] = []
    with open_maybe_gzip(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 8:
                continue
            chrom = cols[0]
            if not all_ctgs and strip_chr(chrom) not in std:
                continue
            pos = int(cols[1])
            info = cols[7]
            svtype, svlen = "", 0
            for part in info.split(";"):
                if part.startswith("SVTYPE="):
                    svtype = part[7:].strip("<>")
                elif part.startswith("SVLEN="):
                    v = part[6:].lstrip(">")
                    try:
                        svlen = abs(int(float(v)))
                    except ValueError:
                        svlen = 0
            if svtype not in ("INS", "DEL", "DUP", "INV", "BND"):
                # infer from ALT when INFO lacks SVTYPE
                alt = cols[4]
                if "[" in alt or "]" in alt:
                    svtype = "BND"
                elif "<" in alt:
                    svtype = alt.strip("<>")
                elif len(cols[3]) > len(alt):
                    svtype = "DEL"
                    svlen = svlen or len(cols[3]) - len(alt)
                else:
                    svtype = "INS"
                    svlen = svlen or len(alt) - len(cols[3])
            # breakends carry no length; everything else honors the size cut
            if svlen < 50 and svtype != "BND":
                continue
            gt, ps = "1|1", "."
            if len(cols) >= 10:
                fmt = cols[8].split(":")
                sample = cols[9].split(":")
                fmap = dict(zip(fmt, sample))
                raw_gt = fmap.get("GT") or fmap.get("HP") or "1|1"
                ps = fmap.get("PS", ".")
                norm = _normalize_gt(raw_gt)
                if norm is None:
                    continue
                gt = norm
            if bed is not None and not _in_bed(bed, chrom, pos):
                continue
            out.append(EvalEntry(strip_chr(chrom), pos, svtype, svlen, gt, ps))
    return out


def _in_bed(bed, chrom, pos) -> bool:
    c = strip_chr(chrom)
    return any(strip_chr(bc) == c and s <= pos <= e for bc, s, e in bed)


def load_bed(path: str) -> list[tuple[str, int, int]]:
    out = []
    with open(path) as f:
        for line in f:
            cols = line.split()
            if len(cols) >= 3:
                out.append((cols[0], int(cols[1]), int(cols[2])))
    return out


def _gt_class(gt: str) -> str:
    if gt in ("1|0", "0|1", "het"):
        return "het"
    return "hom"


@dataclass
class EvalResult:
    n_truth: int
    n_call: int
    call_tp: int
    gt_tp: int
    phase_tp: int
    phase_total: int
    avg_sv_per_ps: float
    matches: list = field(default_factory=list)
    truth_hets: int = 0
    # per-SVTYPE (INS/DEL/INV/DUP/BND) accuracy: {type: (n_truth, n_call,
    # call_tp, gt_tp, phase_tp, phase_total, truth_hets)} — breakends have
    # no SVLEN so they only score here and in the overall numbers via
    # position matching (the reference drops them, sv_phasing_fn.py:189;
    # scoring them is a framework extension for --phase-bnd runs)
    per_type: dict = field(default_factory=dict)

    def _prf(self, tp, denom_p, denom_r):
        p = tp / denom_p if denom_p else 0.0
        r = tp / denom_r if denom_r else 0.0
        f = 2 * p * r / (p + r) if (p + r) else 0.0
        return p, r, f

    @property
    def calling(self):
        return self._prf(self.call_tp, self.n_call, self.n_truth)

    @property
    def genotyping(self):
        return self._prf(self.gt_tp, self.n_call, self.n_truth)

    @property
    def phasing(self):
        # precision over matched phased het pairs; recall vs ALL truth hets
        return self._prf(self.phase_tp, self.phase_total,
                         max(self.truth_hets, self.phase_total))

    def summary(self) -> dict:
        c, g, ph = self.calling, self.genotyping, self.phasing
        out = {
            "truth_svs": self.n_truth, "called_svs": self.n_call,
            "calling": {"precision": round(c[0], 4), "recall": round(c[1], 4), "f1": round(c[2], 4)},
            "genotyping": {"precision": round(g[0], 4), "recall": round(g[1], 4), "f1": round(g[2], 4)},
            "phasing": {"precision": round(ph[0], 4), "recall": round(ph[1], 4), "f1": round(ph[2], 4)},
            "avg_sv_per_phase_set": round(self.avg_sv_per_ps, 3),
        }
        if self.per_type:
            rows = {}
            for t, (nt, nc, ctp, gtp, ptp, ptot, thet) in \
                    sorted(self.per_type.items()):
                row = {"truth": nt, "called": nc}
                for name, tp in (("calling", ctp), ("genotyping", gtp)):
                    p, r, f = self._prf(tp, nc, nt)
                    row[name] = {"precision": round(p, 4),
                                 "recall": round(r, 4), "f1": round(f, 4)}
                p, r, f = self._prf(ptp, ptot, max(thet, ptot))
                row["phasing"] = {"precision": round(p, 4),
                                  "recall": round(r, 4), "f1": round(f, 4)}
                rows[t] = row
            out["per_type"] = rows
        return out


def evaluate_callsets(truth: list[EvalEntry], calls: list[EvalEntry],
                      refdist: int = 1000, pctsim: float = 0.0) -> EvalResult:
    # group truth by (chrom, svtype), position-sorted within each group
    tgroup: dict[tuple[str, str], list[int]] = {}
    for i, t in enumerate(truth):
        tgroup.setdefault((t.chrom, t.svtype), []).append(i)
    for k in tgroup:
        tgroup[k].sort(key=lambda i: truth[i].pos)
    tpos = {k: np.array([truth[i].pos for i in v]) for k, v in tgroup.items()}

    call_tp = 0
    gt_tp = 0
    matches = []  # (call_idx, truth_idx)
    used = set()
    for ci, c in enumerate(calls):
        key = (c.chrom, c.svtype)
        if key not in tgroup:
            continue
        pos_arr = tpos[key]
        # every unused truth candidate within refdist; nearest wins
        lo = int(np.searchsorted(pos_arr, c.pos - refdist, "left"))
        hi = int(np.searchsorted(pos_arr, c.pos + refdist, "right"))
        best = None
        for cand in range(lo, hi):
            ti = tgroup[key][cand]
            if ti in used:
                continue
            d = abs(int(pos_arr[cand]) - c.pos)
            t = truth[ti]
            # breakends have no length: position-only matching
            mx = max(c.svlen, t.svlen)
            ratio = min(c.svlen, t.svlen) / mx if mx else 1.0
            if ratio >= pctsim and (best is None or d < best[0]):
                best = (d, ti)
        if best is not None:
            used.add(best[1])
            call_tp += 1
            matches.append((ci, best[1]))
            if _gt_class(c.gt) == _gt_class(truth[best[1]].gt):
                gt_tp += 1

    # phasing: per call phase set, orientation-invariant het agreement.
    # precision is over matched phased het pairs; recall over ALL truth hets
    # (unmatched truth hets count as misses).  The per-group polarity is
    # chosen over ALL types together (one orientation per phase set), then
    # attributed per type for the breakdown.
    ps_groups: dict[str, list[tuple[str, str, str]]] = {}
    for ci, ti in matches:
        c, t = calls[ci], truth[ti]
        if c.gt in ("1|0", "0|1") and t.gt in ("1|0", "0|1"):
            ps_groups.setdefault(c.ps, []).append((c.gt, t.gt, c.svtype))
    phase_tp = 0
    phase_total = 0
    type_phase: dict[str, list[int]] = {}   # type -> [tp, total]
    flip = {"1|0": "0|1", "0|1": "1|0"}
    for pairs in ps_groups.values():
        same = sum(cg == tg for cg, tg, _ in pairs)
        flipped = sum(flip[cg] == tg for cg, tg, _ in pairs)
        use_flip = flipped > same
        phase_tp += max(same, flipped)
        phase_total += len(pairs)
        for cg, tg, ty in pairs:
            acc = type_phase.setdefault(ty, [0, 0])
            acc[0] += (flip[cg] == tg) if use_flip else (cg == tg)
            acc[1] += 1
    truth_hets = sum(t.gt in ("1|0", "0|1", "het") for t in truth)

    # per-SVTYPE breakdown
    per_type: dict[str, list[int]] = {}
    for t in truth:
        per_type.setdefault(t.svtype, [0] * 7)[0] += 1
        per_type[t.svtype][6] += t.gt in ("1|0", "0|1", "het")
    for c in calls:
        per_type.setdefault(c.svtype, [0] * 7)[1] += 1
    for ci, ti in matches:
        row = per_type[calls[ci].svtype]
        row[2] += 1
        row[3] += _gt_class(calls[ci].gt) == _gt_class(truth[ti].gt)
    for ty, (tp, tot) in type_phase.items():
        per_type.setdefault(ty, [0] * 7)[4] += tp
        per_type[ty][5] += tot

    # avg SVs per phase set over the emitted callset
    ps_counts: dict[str, int] = {}
    for c in calls:
        if c.ps not in (".", ""):
            ps_counts[c.ps] = ps_counts.get(c.ps, 0) + 1
    avg = float(np.mean(list(ps_counts.values()))) if ps_counts else 0.0

    return EvalResult(len(truth), len(calls), call_tp, gt_tp,
                      phase_tp, phase_total, avg, matches,
                      truth_hets=truth_hets,
                      per_type={k: tuple(v) for k, v in per_type.items()})


def evaluate_files(call_vcf: str, truth_vcf: str, refdist: int = 1000,
                   pctsim: float = 0.0, bed_path: str | None = None,
                   all_ctgs: bool = False) -> EvalResult:
    bed = load_bed(bed_path) if bed_path else None
    truth = load_eval_vcf(truth_vcf, all_ctgs, bed)
    calls = load_eval_vcf(call_vcf, all_ctgs, bed)
    return evaluate_callsets(truth, calls, refdist, pctsim)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m duet_tpu_torch.eval.evaluate",
        description="score a phased SV callset against a truth VCF",
    )
    p.add_argument("call_vcf")
    p.add_argument("truth_vcf")
    p.add_argument("-r", "--refdist", type=int, default=1000)
    p.add_argument("-p", "--pctsim", type=float, default=0.0)
    p.add_argument("-b", "--bed", default=None)
    p.add_argument("-a", "--all_ctgs", action="store_true")
    p.add_argument("--skip_phasing", action="store_true",
                   help="report calling/genotyping only (reference "
                        "evaluation.py flag parity)")
    p.add_argument("--reference-semantics", action="store_true",
                   help="score with the reference scorer's exact matching "
                        "rules (nearest base with re-use, per-PS polarity "
                        "pick) so numbers are paper-comparable; the default "
                        "scorer uses stricter nearest-unused matching")
    args = p.parse_args(argv)
    if args.reference_semantics:
        from duet_tpu_torch.eval.reference_semantics import evaluate_files_reference

        print(json.dumps(evaluate_files_reference(
            args.call_vcf, args.truth_vcf, args.refdist, args.pctsim,
            args.bed, args.skip_phasing), indent=2))
        return 0
    res = evaluate_files(args.call_vcf, args.truth_vcf, args.refdist,
                         args.pctsim, args.bed, args.all_ctgs)
    summary = res.summary()
    if args.skip_phasing:
        summary.pop("phasing", None)
        summary.pop("avg_sv_per_phase_set", None)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
