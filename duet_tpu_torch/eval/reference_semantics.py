"""``duet_tpu.eval.reference_semantics``, copied for the port: verbatim but for
its imports.

Reference-exact evaluation semantics (opt-in `--reference-semantics`).

The framework's default scorer (duet_tpu_torch.eval.evaluate) deliberately differs
from the reference's standalone script: it matches each call to the nearest
UNUSED truth record, and scores phasing recall against all truth hets.  The
reference scorer (src/scripts/evaluation.py:99-159) instead matches each
call to its single nearest base ALLOWING RE-USE, and picks the better of the
two phase polarities per call phase set.  Numbers from the two scorers are
NOT comparable; this module reproduces the reference's semantics exactly —
including its quirks — so framework callsets can be scored the way the
duet paper's numbers were:

* only 'chr'-prefixed chr1-22/X/Y records count (evaluation.py:43)
* records without INS/DEL/DUP in INFO or ALT are dropped; DUP scores as INS
  (evaluation.py:46-47,81)
* HP is the first 3 chars of the LAST column; '.' alleles read as '0'
  (evaluation.py:54-59)
* unphased records other than '1/1' are dropped when phasing is scored
  (evaluation.py:60-68)
* phase-set key: phased records group by (chrom, PS tail of the sample
  column); unphased '1/1' records group by chrom (evaluation.py:63-73)
* missing SVLEN => length from len(REF)-len(ALT) (evaluation.py:82-89)
* matching: per (chrom, call phase set, svtype), each call matched to its
  nearest base by position (right-preference on ties), bases re-usable;
  TP iff distance <= refdist and reciprocal length ratio >= pctsim
  (evaluation.py:117-127)
* genotype TP: both het (either orientation) or both '1|1'
  (evaluation.py:130-133)
* phasing TP: per call phase set, the better of same-orientation vs
  flipped-orientation match sets; exact ties pick the flipped set
  (evaluation.py:134-153)
* P = |call TPs| / #calls, R = |base TPs| / #bases over the whole callsets
  (evaluation.py:155-163)
"""

from __future__ import annotations

import numpy as np

from duet_tpu_torch.utils.chrom import standard_chrom_names


def _read_rows(path: str) -> list[list[str]]:
    from duet_tpu_torch.io.vcf import open_maybe_gzip

    with open_maybe_gzip(path) as f:
        return [ln.strip().split() for ln in f if ln.strip()]


def parse_bed_ranges(path: str) -> dict[str, list[tuple[int, int]]]:
    """chrom -> inclusive (start, end) windows, chr-prefixed keys only."""
    out: dict[str, list[tuple[int, int]]] = {}
    for cols in _read_rows(path):
        if len(cols) >= 3:
            out.setdefault(cols[0], []).append((int(cols[1]), int(cols[2])))
    return out


def parse_vcf_reference(path: str, skip_phasing: bool,
                        bed_path: str | None = None) -> list[dict]:
    chrom_list = set(standard_chrom_names())
    bed = parse_bed_ranges(bed_path) if bed_path else None
    info: list[dict] = []
    for s in _read_rows(path):
        if s[0][0] == "#":
            continue
        if s[0][3:] not in chrom_list:  # requires the 'chr' prefix
            continue
        if "SVLEN=." in s[7]:
            continue
        if ("INS" not in s[7] and "DEL" not in s[7] and "DUP" not in s[7]
                and "INS" not in s[4] and "DEL" not in s[4]
                and "DUP" not in s[4]):
            continue
        rec = {
            "chr": s[0],
            "pos": int(s[1]),
            "id": s[2] + s[0] + s[1],
            "hp": s[-1][:3],
        }
        if rec["hp"][0] == ".":
            rec["hp"] = "0" + rec["hp"][1:]
        if rec["hp"][2] == ".":
            rec["hp"] = rec["hp"][:2] + "0"
        if rec["hp"][1] == "/":
            if not skip_phasing and rec["hp"] != "1/1":
                continue
            rec["hp"] = rec["hp"][0] + "|" + rec["hp"][2]
            rec["ps"] = s[0]
        else:
            rec["ps"] = s[0] + "_" + s[-1][s[-1].rfind(":"):]
        sv_info = s[7].split(";")
        if "SVLEN" in s[7]:
            svlen_part = [p for p in sv_info if "SVLEN" in p][0]
            rec["len"] = abs(int(svlen_part[7:])) if "SVLEN=>" in s[7] \
                else abs(int(svlen_part[6:]))
            if s[4] in ("<INS>", "<DEL>", "<DUP:TANDEM>", "<DUP:INT>", "<DUP>"):
                rec["type"] = s[4][1:-1]
            else:
                rec["type"] = [p for p in sv_info if "SVTYPE" in p][0][7:]
            if "DUP" in rec["type"]:
                rec["type"] = "INS"
        else:
            delta = len(s[3]) - len(s[4])
            if delta == 0:
                continue
            rec["len"] = abs(delta)
            rec["type"] = "DEL" if delta > 0 else "INS"
        if bed is not None:
            windows = bed.get(s[0], [])
            if not any(a <= rec["pos"] <= b for a, b in windows):
                continue
        if rec["len"] < 50 or rec["hp"] == "0|0":
            continue
        info.append(rec)
    return info


def evaluation_reference(baseinfo: list[dict], callinfo: list[dict],
                         refdist: int, ratio: float) -> dict:
    call_tp, base_tp = set(), set()
    call_tp_gt, base_tp_gt = set(), set()
    call_tp_hp, base_tp_hp = set(), set()
    ps_values = {s["ps"] for s in callinfo}
    avg_sv_num = len(callinfo) / len(ps_values) if ps_values else 0.0
    for name in standard_chrom_names():
        chrom = "chr" + name
        base_ch_type = {
            svtype: sorted((s for s in baseinfo
                            if s["chr"] == chrom and s["type"] == svtype),
                           key=lambda s: s["pos"])
            for svtype in ("INS", "DEL")
        }
        call_ch = [s for s in callinfo if s["chr"] == chrom]
        for ps in {s["ps"] for s in call_ch}:
            call_ch_ps = [s for s in call_ch if s["ps"] == ps]
            tmp1_call, tmp1_base = set(), set()
            tmp2_call, tmp2_base = set(), set()
            for svtype in ("INS", "DEL"):
                call = [s for s in call_ch_ps if s["type"] == svtype]
                base = base_ch_type[svtype]
                if not call or not base:
                    continue
                base_pos = [s["pos"] for s in base]
                idx_list = np.searchsorted(base_pos, [s["pos"] for s in call])
                for k in range(len(idx_list)):
                    # nearest base, re-usable, right-preference on ties
                    if idx_list[k] == len(base):
                        bi = idx_list[k] - 1
                    elif idx_list[k] > 0 and \
                            abs(call[k]["pos"] - base[idx_list[k]]["pos"]) > \
                            abs(call[k]["pos"] - base[idx_list[k] - 1]["pos"]):
                        bi = idx_list[k] - 1
                    else:
                        bi = idx_list[k]
                    c, b = call[k], base[bi]
                    if abs(c["pos"] - b["pos"]) <= refdist and \
                            min(c["len"], b["len"]) / max(c["len"], b["len"]) >= ratio:
                        call_tp.add(c["id"])
                        base_tp.add(b["id"])
                        if (c["hp"] in ("1|0", "0|1") and b["hp"] in ("1|0", "0|1")) \
                                or c["hp"] == b["hp"] == "1|1":
                            call_tp_gt.add(c["id"])
                            base_tp_gt.add(b["id"])
                        if c["hp"] == b["hp"]:
                            tmp1_call.add(c["id"])
                            tmp1_base.add(b["id"])
                        if c["hp"] == b["hp"] == "1|1" or \
                                (c["hp"] == "0|1" and b["hp"] == "1|0") or \
                                (c["hp"] == "1|0" and b["hp"] == "0|1"):
                            tmp2_call.add(c["id"])
                            tmp2_base.add(b["id"])
            # ties pick the FLIPPED orientation (reference uses strict '>')
            if len(tmp1_call) + len(tmp1_base) > len(tmp2_call) + len(tmp2_base):
                call_tp_hp |= tmp1_call
                base_tp_hp |= tmp1_base
            else:
                call_tp_hp |= tmp2_call
                base_tp_hp |= tmp2_base

    def prf(ctp, btp):
        p = len(ctp) / len(callinfo) if callinfo else 0.0
        r = len(btp) / len(baseinfo) if baseinfo else 0.0
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        return {"precision": p, "recall": r, "f1": f1}

    return {
        "avg_sv_per_phase_set": avg_sv_num,
        "calling": prf(call_tp, base_tp),
        "genotyping": prf(call_tp_gt, base_tp_gt),
        "phasing": prf(call_tp_hp, base_tp_hp),
    }


def evaluate_files_reference(call_vcf: str, truth_vcf: str,
                             refdist: int = 1000, pctsim: float = 0.0,
                             bed_path: str | None = None,
                             skip_phasing: bool = False) -> dict:
    base = parse_vcf_reference(truth_vcf, skip_phasing, bed_path)
    call = parse_vcf_reference(call_vcf, skip_phasing, bed_path)
    out = evaluation_reference(base, call, refdist, pctsim)
    out["semantics"] = "reference"
    if skip_phasing:
        out.pop("phasing", None)
        out.pop("avg_sv_per_phase_set", None)
    return out
