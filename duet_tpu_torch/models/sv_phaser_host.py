"""The host half of ``duet_tpu.models.sv_phaser``, copied for the port.

The functions, classes and constants that the port's stage code uses, and
what they call, verbatim but for their imports.

SV genotyping + phasing: signature integration and the T1-T5 decision rule.

This is the framework's re-design of the reference compute core
(src/duet/sv_phasing_fn.py). The per-call Python dict loops of the reference
become packed, padded arrays over (calls x support-read slots) with masked
reductions — the same layout the device kernel (duet_tpu.ops.phase_decide)
consumes — while reproducing reference behavior decision-for-decision:

* the pc <= 8100 confidence cut on haplotype evidence (sv_phasing_fn.py:76,88)
* phase-set-regime partitioning by the number of distinct PS values among a
  call's tagged reads, counted WITHOUT the pc cut (sv_phasing_fn.py:191-194)
* per-chromosome oneps sets from the first pc-qualifying tagged read of each
  single-PS call (sv_phasing_fn.py:195-203)
* the regime-specific feature tallies incl. the max-support PS selection with
  first-seen tie-break in the two-PS regime (sv_phasing_fn.py:70-140)
* nearest-phase-set fallback with right-preference on distance ties
  (sv_phasing_fn.py:106-111)
* the exact T1-T5 thresholds of the trained tree (sv_phasing_fn.py:142-183)
* signed SVLEN by type, lexicographic-chrom output order
  (sv_phasing_fn.py:225,229)

All features are computed in float64, matching Python-float arithmetic in the
reference bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from duet_tpu_torch.io.vcf import SVRecord


PC_CONFIDENCE_MAX = 8100  # reference sv_phasing_fn.py:76


@dataclass
class PackedCalls:
    """Callset of one chromosome packed for vectorized phasing.

    Per-read-slot arrays are padded to the widest support list; `tagged`
    marks slots whose read carried HP/PC/PS haplotype info.
    """

    n: int
    pos: np.ndarray          # (n,) int64, 1-based VCF POS
    svread: np.ndarray       # (n,) int64 support-read count (INFO)
    refread: np.ndarray      # (n,) int64 reference-read count (FORMAT)
    n_slots: np.ndarray      # (n,) int64 length of the read-name list
    hap: np.ndarray          # (n, S) int8   1/2, 0 where untagged
    ps: np.ndarray           # (n, S) int64  phase-set id, -1 where untagged
    pc: np.ndarray           # (n, S) int64  phasing cost, huge where untagged
    tagged: np.ndarray       # (n, S) bool
    records: list[SVRecord]  # original records, index-aligned


def attach_read_haplotypes(
    records: list[SVRecord], read_hap: dict[str, tuple[int, int, int]]
) -> None:
    """Join each call's read-name list against the per-read haplotype map
    (name -> (hap, ps, pc)); untagged reads get None. Mirrors the enrichment
    join of reference generate_callinfo (sv_phasing_fn.py:46-48)."""
    for rec in records:
        rec.read_haps = [read_hap.get(name) for name in rec.read_names]


def pack_calls(records: list[SVRecord]) -> PackedCalls:
    n = len(records)
    S = max((len(r.read_names) for r in records), default=1)
    S = max(S, 1)
    hap = np.zeros((n, S), dtype=np.int8)
    ps = np.full((n, S), -1, dtype=np.int64)
    pc = np.full((n, S), np.iinfo(np.int64).max // 2, dtype=np.int64)
    tagged = np.zeros((n, S), dtype=bool)
    pos = np.zeros(n, dtype=np.int64)
    svread = np.zeros(n, dtype=np.int64)
    refread = np.zeros(n, dtype=np.int64)
    n_slots = np.zeros(n, dtype=np.int64)
    for i, rec in enumerate(records):
        pos[i] = rec.pos
        svread[i] = rec.support
        refread[i] = rec.ref_reads
        n_slots[i] = len(rec.read_names)
        for j, info in enumerate(rec.read_haps):
            if info is not None:
                hap[i, j] = info[0]
                ps[i, j] = info[1]
                pc[i, j] = info[2]
                tagged[i, j] = True
    return PackedCalls(n, pos, svread, refread, n_slots, hap, ps, pc, tagged, records)


def distinct_ps_regime(packed: PackedCalls) -> np.ndarray:
    """Per call: 0 (no tagged reads), 1 (single phase set), 2 (several).

    Distinct-PS counting deliberately ignores the pc cut
    (reference sv_phasing_fn.py:191-194 uses all tagged reads)."""
    ps = np.where(packed.tagged, packed.ps, -1)
    srt = np.sort(ps, axis=1)
    changes = (srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] >= 0)
    first_valid = srt[:, :1] >= 0
    ndistinct = changes.sum(axis=1) + first_valid[:, 0].astype(np.int64)
    return np.minimum(ndistinct, 2)


def build_oneps_set(packed: PackedCalls, keep: np.ndarray, regime: np.ndarray) -> np.ndarray:
    """Sorted unique phase-set anchor positions for one chromosome: for each
    kept single-PS call, the PS of its first tagged read passing the pc cut
    (reference sv_phasing_fn.py:195-203 breaks after the first such read)."""
    rows = np.flatnonzero(keep & (regime == 1))
    qual = packed.tagged & (packed.pc <= PC_CONFIDENCE_MAX)
    out = set()
    for i in rows:
        j = np.flatnonzero(qual[i])
        if len(j):
            out.add(int(packed.ps[i, j[0]]))
    return np.sort(np.array(sorted(out), dtype=np.int64))


def _nearest_ps(oneps_sorted: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Nearest anchor with right-preference on exact distance ties
    (reference sv_phasing_fn.py:106-111 keeps the left element only when it
    is STRICTLY closer)."""
    idx = np.searchsorted(oneps_sorted, pos)
    left = np.maximum(idx - 1, 0)
    right = np.minimum(idx, len(oneps_sorted) - 1)
    take_left = np.abs(pos - oneps_sorted[left]) < np.abs(pos - oneps_sorted[right])
    return np.where(take_left, oneps_sorted[left], oneps_sorted[right])


@dataclass
class PhaseFeatures:
    """Per-call feature block (float64), reference get_phase_info parity."""

    hap1: np.ndarray
    hap2: np.ndarray
    hap0: np.ndarray
    allhap: np.ndarray
    hap1_totsc: np.ndarray
    hap2_totsc: np.ndarray
    hap1_avgsc: np.ndarray
    hap2_avgsc: np.ndarray
    ps: np.ndarray
    hapread_ratio: np.ndarray
    sv_ratio: np.ndarray
    totsc_ratio: np.ndarray
    onehap_totsc: np.ndarray
    hap_avgsc_diff: np.ndarray
    ref_num: np.ndarray
    sv_num: np.ndarray


def compute_features(
    packed: PackedCalls,
    regime: np.ndarray,
    oneps_sorted: np.ndarray,
) -> PhaseFeatures:
    n, S = packed.tagged.shape
    q = packed.tagged & (packed.pc <= PC_CONFIDENCE_MAX)
    pcf = packed.pc.astype(np.float64)

    is1 = regime == 1
    is2 = regime == 2

    # --- single-phase-set tallies (regime 1) -------------------------------
    m1 = q & (packed.hap == 1)
    m2 = q & (packed.hap == 2)
    hap1_r1 = m1.sum(axis=1).astype(np.float64)
    hap2_r1 = m2.sum(axis=1).astype(np.float64)
    sc1_r1 = np.where(m1, pcf, 0.0).sum(axis=1)
    sc2_r1 = np.where(m2, pcf, 0.0).sum(axis=1)
    # PS of the last qualifying read (reference overwrites per read, :77)
    any_q = q.any(axis=1)
    last_q = S - 1 - np.argmax(q[:, ::-1], axis=1)
    ps_r1 = np.where(any_q, packed.ps[np.arange(n), last_q], 0)

    # --- two-phase-set tallies (regime 2) ----------------------------------
    in_ops = q & np.isin(packed.ps, oneps_sorted)
    # support count of each slot's phase set within the call
    same = in_ops[:, :, None] & in_ops[:, None, :] & (
        packed.ps[:, :, None] == packed.ps[:, None, :]
    )
    tot = same.sum(axis=2)
    tot_masked = np.where(in_ops, tot, -1)
    best = np.argmax(tot_masked, axis=1)  # earliest slot of the max-count PS
    has_ops = in_ops.any(axis=1)
    ps_best = packed.ps[np.arange(n), best]
    sel = in_ops & (packed.ps == ps_best[:, None])
    s1 = sel & (packed.hap == 1)
    s2 = sel & (packed.hap == 2)
    hap1_r2 = np.where(has_ops, s1.sum(axis=1), 0).astype(np.float64)
    hap2_r2 = np.where(has_ops, s2.sum(axis=1), 0).astype(np.float64)
    sc1_r2 = np.where(has_ops, np.where(s1, pcf, 0.0).sum(axis=1), 0.0)
    sc2_r2 = np.where(has_ops, np.where(s2, pcf, 0.0).sum(axis=1), 0.0)
    allhap_r2 = q.sum(axis=1).astype(np.float64)
    hap0_r2 = np.where(has_ops, allhap_r2 - hap1_r2 - hap2_r2, 0.0)
    ps_r2 = np.where(has_ops, ps_best, 0)

    hap1 = np.where(is1, hap1_r1, np.where(is2, hap1_r2, 0.0))
    hap2 = np.where(is1, hap2_r1, np.where(is2, hap2_r2, 0.0))
    sc1 = np.where(is1, sc1_r1, np.where(is2, sc1_r2, 0.0))
    sc2 = np.where(is1, sc2_r1, np.where(is2, sc2_r2, 0.0))
    allhap = np.where(is1, hap1_r1 + hap2_r1, np.where(is2, allhap_r2, 0.0))
    hap0 = np.where(is2, hap0_r2, 0.0)
    ps_out = np.where(is1, ps_r1, np.where(is2, ps_r2, 0)).astype(np.int64)

    # --- nearest-anchor fallback (regime 0, or no qualifying evidence) -----
    fallback = (regime == 0) | ((hap1 == 0) & (hap2 == 0))
    if fallback.any():
        ps_out = np.where(fallback, _nearest_ps(oneps_sorted, packed.pos), ps_out)

    # --- derived features (float64 exactly as reference lines 112-139) -----
    with np.errstate(divide="ignore", invalid="ignore"):
        hapread_ratio = allhap / packed.n_slots.astype(np.float64)
        hap1_avgsc = np.where(hap1 > 0, sc1 / np.where(hap1 > 0, hap1, 1), 0.0)
        hap2_avgsc = np.where(hap2 > 0, sc2 / np.where(hap2 > 0, hap2, 1), 0.0)
        sv_ratio = packed.svread / (packed.svread + packed.refread).astype(np.float64)
        mn = np.minimum(sc1, sc2)
        mx = np.maximum(sc1, sc2)
        totsc_ratio = np.where(mn > 0, mx / np.where(mn > 0, mn, 1), 0.0)
        onehap_totsc = np.where(mn == 0, mx, 0.0)
    hap_avgsc_diff = np.abs(hap2_avgsc - hap1_avgsc)

    return PhaseFeatures(
        hap1=hap1, hap2=hap2, hap0=hap0, allhap=allhap,
        hap1_totsc=sc1, hap2_totsc=sc2,
        hap1_avgsc=hap1_avgsc, hap2_avgsc=hap2_avgsc, ps=ps_out,
        hapread_ratio=hapread_ratio, sv_ratio=sv_ratio,
        totsc_ratio=totsc_ratio, onehap_totsc=onehap_totsc,
        hap_avgsc_diff=hap_avgsc_diff,
        ref_num=packed.refread.astype(np.float64),
        sv_num=packed.svread.astype(np.float64),
    )


def decide_haplotype(f: PhaseFeatures, regime: np.ndarray) -> np.ndarray:
    """The trained T1-T5 decision tree, vectorized & branchless.

    Returns per-call prediction: 0 filtered, 1 -> '1|0', 2 -> '0|1',
    3 -> '1|1'. Threshold constants are the reference's verbatim
    (sv_phasing_fn.py:142-183). The reference's `sv_num >= 20` pre-rule
    (line 157) only re-assigns the initial 0 and is always overridden by the
    branches below, so it imposes no filter and is intentionally absent.
    """
    pred = np.zeros(len(regime), dtype=np.int64)

    # regime 0: homozygous call on pure SV support
    r0 = (regime == 0) & (f.sv_ratio == 1.0) & (f.sv_num >= 4)
    pred = np.where(r0, 3, pred)

    # regime 2: cross-phase-set homozygous evidence
    r2 = (regime == 2) & (f.sv_ratio >= 0.72) & (
        np.where(f.hap_avgsc_diff <= 1369.50, f.sv_num >= 3, f.hap0 >= 6)
    )
    pred = np.where(r2, 3, pred)

    # regime 1
    is1 = regime == 1
    onehap = f.onehap_totsc != 0
    gate = ((f.hapread_ratio <= 0.75) & (f.hap_avgsc_diff <= 2400)) | (f.hapread_ratio > 0.75)
    het_side_avg = np.where(f.hap1_avgsc > 0, 1, 2)
    # evidence on exactly one haplotype
    b_mid = (f.sv_ratio > 0.24) & (f.sv_ratio <= 0.9) & gate
    b_hi = (f.sv_ratio > 0.9) & gate
    p_one = np.where(b_mid, het_side_avg, np.where(b_hi, 3, 0))
    # evidence on both / neither haplotype
    het_side_tot = np.where(f.hap1_totsc > f.hap2_totsc, 1, 2)
    p_both = np.zeros_like(pred)
    band2 = (f.sv_ratio > 0.3) & (f.sv_ratio <= 0.45)
    band3 = (f.sv_ratio > 0.45) & (f.sv_ratio <= 0.75)
    band4 = f.sv_ratio > 0.75
    p_both = np.where(band2, np.where(f.ref_num > 10, 0, het_side_tot), p_both)
    p_both = np.where(band3, np.where(f.totsc_ratio <= 9.72, 3, het_side_tot), p_both)
    p_both = np.where(band4, 3, p_both)
    pred = np.where(is1, np.where(onehap, p_one, p_both), pred)
    return pred


HP_STRINGS = {1: "1|0", 2: "0|1", 3: "1|1"}
