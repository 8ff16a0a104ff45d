"""Diploid genome + ONT-like long-read simulator.

The reference validates itself against a downloadable HG00733 chr21 demo
(reference README.md:81-92); with no network egress this module provides the
equivalent reproducible test bed: a random reference contig, a phased diploid
variant set (het/hom SNPs, INS/DEL SVs with known haplotype), and noisy long
reads written as a real BAM through duet_tpu.io — exercising the full ingest
path end-to-end. The truth VCF feeds the evaluation harness
(reference src/scripts/evaluation.py semantics).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from duet_tpu_torch.io.bam import BamHeader, BamRead, BamWriter, write_bam_index
from duet_tpu_torch.io.fasta import decode_bases, write_fasta
from duet_tpu_torch.io.vcf import write_vcf


@dataclass
class SimConfig:
    contigs: dict[str, int] = field(default_factory=lambda: {"chr21": 400_000})
    seed: int = 0
    coverage: float = 20.0
    read_len_mean: int = 12_000
    read_len_sigma: float = 0.35  # lognormal-ish spread
    snp_rate: float = 1.0 / 1000  # het SNP density
    hom_snp_fraction: float = 0.35
    sv_count_per_mb: float = 60.0
    sv_len_min: int = 60
    sv_len_max: int = 600
    hom_sv_fraction: float = 0.25
    inv_fraction: float = 0.0   # share of SV events that are inversions
    dup_fraction: float = 0.0   # share that are tandem duplications
    tra_count: int = 0          # inter-contig translocation junctions (needs >=2 contigs)
    split_del_min: int = 0      # aligner realism: DELs >= this size are
                                # emitted as split alignments (two colinear
                                # segments) instead of one CIGAR D run; 0 off
    sub_error: float = 0.02
    indel_error: float = 0.01  # small 1-3bp sequencing indels
    qual_mean: int = 22
    # ONT error SHAPE (round-5, VERDICT r4 next #6): real nanopore error is
    # not uniform — it concentrates in homopolymers (dominant mode: +-1
    # base at a run) and correlates WITHIN a read (bad pores/strands yield
    # whole bad reads).  A uniform model is the easiest regime for the
    # counting caller and the junction-evidence thresholds; these two
    # fields make the sim adversarial in the same way real data is.
    #   hp_indel_rate      per crossed homopolymer run of length >= 3, the
    #                      prob of a +-1bp indel is
    #                      min(rate * mult * (len-2)^hp_indel_exponent, .5)
    #   read_qual_wander   lognormal sigma of the per-read error
    #                      MULTIPLIER; substitutions scale by it and the
    #                      read's quals shift by -10*log10(mult), so bad
    #                      reads announce themselves the way real basecalls
    #                      do
    hp_indel_rate: float = 0.012
    hp_indel_exponent: float = 1.6
    read_qual_wander: float = 0.45
    # spurious SV-sized insertion ARTIFACTS (library/basecall chimeras and
    # homopolymer slippage — what real ONT data has and a clean simulation
    # lacks).  They are never in the truth VCF, so the calls they seed are
    # genuine false positives: the training source for the learned decision
    # layer's class-0 (filtered) rows.  Insertions only: a post-hoc
    # deletion artifact would mis-shift every downstream base of the read,
    # which no aligner output exhibits.
    artifact_ins_rate: float = 0.0   # per-read prob of one random-position INS
    artifact_hotspots: int = 0       # recurrent slippage sites per contig...
    artifact_hotspot_carry: float = 0.3  # ...each crossing read carries at this rate
    artifact_len_min: int = 60
    artifact_len_max: int = 220


@dataclass
class SimTruth:
    # per contig
    snp_pos: dict[str, np.ndarray]       # 0-based positions
    snp_ref: dict[str, np.ndarray]       # base codes
    snp_alt: dict[str, np.ndarray]
    snp_gt: dict[str, np.ndarray]        # (n,2) alt-presence per hap
    sv_pos: dict[str, np.ndarray]        # 0-based position (base before event)
    sv_len: dict[str, np.ndarray]        # +ins/inv/dup, -del
    sv_gt: dict[str, np.ndarray]         # (n,2) presence per hap
    sv_kind: dict[str, np.ndarray]       # 0 INS, 1 DEL, 2 INV, 3 DUP
    sv_ins_seq: dict[str, list]          # inserted sequences (codes) or None
    read_hap: dict[str, int]             # read name -> haplotype (0/1)
    # inter-contig translocation junctions:
    # (contig_a, pos_a, contig_b, pos_b, gt (2,)) — reads on contig_a crossing
    # pos_a on a carrying haplotype continue on contig_b at pos_b
    tra: list = field(default_factory=list)


def _rand_codes(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 4, size=n, dtype=np.uint8)


def _simulate_variants(rng, length, cfg):
    """Phased SNPs + SVs for one contig; SVs kept clear of each other and of
    SNP positions."""
    n_snp = rng.poisson(length * cfg.snp_rate)
    snp_pos = np.sort(rng.choice(np.arange(500, length - 500), size=min(n_snp, length // 4), replace=False))
    hom = rng.random(len(snp_pos)) < cfg.hom_snp_fraction
    which_hap = rng.integers(0, 2, size=len(snp_pos))
    snp_gt = np.zeros((len(snp_pos), 2), dtype=np.int8)
    snp_gt[hom] = 1
    snp_gt[~hom, which_hap[~hom]] = 1

    n_sv = max(2, rng.poisson(length / 1e6 * cfg.sv_count_per_mb))
    # place SVs on a coarse grid to avoid overlap
    grid = np.arange(2_000, length - 3_000, max(cfg.sv_len_max * 4, 3_000))
    rng.shuffle(grid)
    sv_pos = np.sort(grid[: min(n_sv, len(grid))].copy())
    n = len(sv_pos)
    u = rng.random(n)
    # kind: 0 INS, 1 DEL, 2 INV, 3 DUP
    sv_kind = np.where(u < cfg.inv_fraction, 2,
                       np.where(u < cfg.inv_fraction + cfg.dup_fraction, 3,
                                np.where(rng.random(n) < 0.5, 0, 1))).astype(np.int8)
    sv_size = rng.integers(cfg.sv_len_min, cfg.sv_len_max + 1, size=n)
    sv_len = np.where(sv_kind == 1, -sv_size, sv_size).astype(np.int64)
    hom_sv = rng.random(n) < cfg.hom_sv_fraction
    sv_hap = rng.integers(0, 2, size=n)
    sv_gt = np.zeros((n, 2), dtype=np.int8)
    sv_gt[hom_sv] = 1
    sv_gt[~hom_sv, sv_hap[~hom_sv]] = 1
    ins_seq = [(_rand_codes(rng, s) if k == 0 else None)
               for k, s in zip(sv_kind, sv_size)]

    # drop SNPs inside event spans so hap sequences stay consistent
    keep = np.ones(len(snp_pos), dtype=bool)
    for p, l, k in zip(sv_pos, sv_len, sv_kind):
        if k in (1, 2, 3):
            keep &= ~((snp_pos > p) & (snp_pos <= p + abs(l)))
    return (snp_pos[keep], snp_gt[keep], sv_pos, sv_len, sv_gt, sv_kind, ins_seq)


def _revcomp(codes: np.ndarray) -> np.ndarray:
    return np.where(codes < 4, 3 - codes[::-1], 4).astype(np.uint8)


def _apply_sub_errors(rng, codes, cfg, err_mult: float = 1.0):
    n = len(codes)
    if n == 0:
        return codes
    sub_mask = rng.random(n) < min(cfg.sub_error * err_mult, 0.5)
    if sub_mask.any():
        codes = codes.copy()
        codes[sub_mask] = (codes[sub_mask]
                           + rng.integers(1, 4, size=int(sub_mask.sum()))) % 4
    return codes


def _apply_hp_indels(rng, codes, quals, seg_cig, cfg, err_mult: float = 1.0):
    """Homopolymer-length-dependent +-1bp indels (the dominant real-ONT
    error mode).  Each maximal run of >= 3 identical emitted bases draws an
    indel with probability growing in run length; an insertion duplicates
    the run base in place (cigar I), a deletion drops one run base against
    the reference (cigar D).  Events land only inside M runs — content
    inside existing I runs (e.g. SV insertion sequence) is skipped, which
    keeps the surgery exact.  Reference consumption is preserved, so the
    segment stays alignment-consistent."""
    rate = cfg.hp_indel_rate * err_mult
    if rate <= 0 or len(codes) < 20:
        return codes, quals, seg_cig
    c = codes
    change = np.flatnonzero(np.r_[True, c[1:] != c[:-1], True])
    starts, lens = change[:-1], np.diff(change)
    runs = np.flatnonzero(lens >= 3)
    if not len(runs):
        return codes, quals, seg_cig
    p = np.minimum(rate * (lens[runs] - 2.0) ** cfg.hp_indel_exponent, 0.5)
    hit = runs[rng.random(len(runs)) < p]
    if not len(hit):
        return codes, quals, seg_cig
    events = sorted(
        (int(starts[r] + lens[r] // 2), 1 if rng.random() < 0.5 else -1)
        for r in hit)
    new_cig: list[list[int]] = []
    parts_c: list[np.ndarray] = []
    parts_q: list[np.ndarray] = []

    def emit(op, ln):
        if ln <= 0:
            return
        if new_cig and new_cig[-1][0] == op:
            new_cig[-1][1] += ln
        else:
            new_cig.append([op, ln])

    q = 0
    ei = 0
    for op, ln in seg_cig:
        if op == 0:
            cur = q
            while ei < len(events) and events[ei][0] < q + ln:
                eq, kind = events[ei]
                ei += 1
                parts_c.append(c[cur:eq])
                parts_q.append(quals[cur:eq])
                emit(0, eq - cur)
                if kind == 1:           # duplicate the run base
                    parts_c.append(c[eq:eq + 1])
                    parts_q.append(quals[eq:eq + 1])
                    emit(1, 1)
                    cur = eq
                else:                   # drop one base against the reference
                    emit(2, 1)
                    cur = eq + 1
            parts_c.append(c[cur:q + ln])
            parts_q.append(quals[cur:q + ln])
            emit(0, q + ln - cur)
            q += ln
        elif op == 1:
            while ei < len(events) and events[ei][0] < q + ln:
                ei += 1                 # no events inside insertions
            parts_c.append(c[q:q + ln])
            parts_q.append(quals[q:q + ln])
            emit(1, ln)
            q += ln
        else:                           # D: consumes no query
            emit(op, ln)
    return (np.concatenate(parts_c) if parts_c else c[:0],
            np.concatenate(parts_q) if parts_q else quals[:0], new_cig)


def _inject_ins_artifact(codes, quals, seg_cig, cut, k, rng, cfg):
    """Splice a k-base random insertion at query offset `cut`: content and
    quals gain the bases, the cigar gains an I run at the split point.
    Downstream reference mapping is untouched (insertions consume query
    only), so the read stays alignment-consistent."""
    ins = _rand_codes(rng, k)
    codes = np.concatenate([codes[:cut], ins, codes[cut:]])
    quals = np.concatenate(
        [quals[:cut], np.full(k, cfg.qual_mean, np.uint8), quals[cut:]])
    new_cig: list[list[int]] = []
    q = 0
    inserted = False
    for op, ln in seg_cig:
        consumes_q = op in (0, 1)
        if not inserted and consumes_q and q < cut <= q + ln:
            a = cut - q
            if a > 0:
                new_cig.append([op, a])
            new_cig.append([1, k])
            if ln - a > 0:
                new_cig.append([op, ln - a])
            inserted = True
        else:
            new_cig.append([op, ln])
        if consumes_q:
            q += ln
    if not inserted:
        new_cig.append([1, k])
    return codes, quals, new_cig


def _query_cut_at(seg_cig, ref_start, h):
    """Query offset of reference position `h` under the segment's cigar,
    or None when h lands outside every M run."""
    q, r = 0, ref_start
    for op, ln in seg_cig:
        if op == 0 and r <= h < r + ln:
            return q + (h - r)
        if op in (0, 2):
            r += ln
        if op in (0, 1):
            q += ln
    return None


def _simulate_read(rng, ref_codes, start, target_span, hap,
                   snp_pos, snp_gt, snp_alt, sv_pos, sv_len, sv_gt, sv_kind,
                   ins_seq, cfg, tra_events=None, all_codes=None,
                   all_snps=None, hotspots=None):
    """Walk the reference from `start`, emitting the haplotype's bases with
    sequencing errors.  Returns a list of alignment segments
    [(contig, ref_start, strand, codes, quals, cigar)] in read order —
    contig is None for the home contig; one segment for plain reads, several
    when the read crosses a carried INV, DUP, or translocation junction
    (the simulator plays aligner and splits exactly at the breakpoints).
    Segment codes/quals are in the STORED (reference-forward) orientation;
    a minus-strand segment's read content is the reverse complement.

    tra_events: position-sorted [(pos_a, contig_b, pos_b, gt (2,))] junctions
    on this contig; a carrying read crossing pos_a continues on contig_b at
    pos_b.  all_codes[contig] -> reference codes; all_snps[contig] ->
    (snp_pos, snp_gt, snp_alt): the derivative chromosome fuses haplotype
    `hap` of both contigs, so the partner segment carries contig_b's hap
    alleles — keeping its SNP evidence phase-consistent."""
    segments = []  # (contig_or_None, ref_start, strand, seq_parts, cig)
    seq: list = []
    cig: list[list[int]] = []  # [op, len]; op: 0=M 1=I 2=D
    seg_ref_start = start
    tra_events = tra_events or []
    tra_pos = np.array([t[0] for t in tra_events], dtype=np.int64)

    def add(op, ln):
        if ln <= 0:
            return
        if cig and cig[-1][0] == op:
            cig[-1][1] += ln
        else:
            cig.append([op, ln])

    def close_segment():
        nonlocal seq, cig
        if seq:
            segments.append((None, seg_ref_start, 0, seq, cig))
        seq, cig = [], []

    sv_idx = np.searchsorted(sv_pos, start)
    snp_idx = np.searchsorted(snp_pos, start)
    tra_idx = int(np.searchsorted(tra_pos, start))
    pos = start
    end_target = min(start + target_span, len(ref_codes))
    while pos < end_target:
        # translocation junction: carried reads jump to the partner contig
        if tra_idx < len(tra_pos) and pos >= tra_pos[tra_idx]:
            _, dest_contig, dest_pos, tgt = tra_events[tra_idx]
            tra_idx += 1
            if tgt[hap]:
                close_segment()
                dest_codes = all_codes[dest_contig]
                v = min(end_target - pos, len(dest_codes) - dest_pos)
                if v >= 30:
                    dest = dest_codes[dest_pos:dest_pos + v].copy()
                    if all_snps and dest_contig in all_snps:
                        dpos, dgt, dalt = all_snps[dest_contig]
                        lo = np.searchsorted(dpos, dest_pos)
                        hi = np.searchsorted(dpos, dest_pos + v)
                        for s in range(lo, hi):
                            if dgt[s, hap]:
                                dest[dpos[s] - dest_pos] = dalt[s]
                    segments.append((
                        dest_contig, dest_pos, 0, [dest],
                        [[0, int(v)]],
                    ))
                break  # the read ends on the partner contig
            continue
        next_sv = sv_pos[sv_idx] if sv_idx < len(sv_pos) else end_target
        next_snp = snp_pos[snp_idx] if snp_idx < len(snp_pos) else end_target
        next_tra = tra_pos[tra_idx] if tra_idx < len(tra_pos) else end_target
        nxt = min(next_sv, next_snp, next_tra, end_target)
        if nxt > pos:
            seq.append(ref_codes[pos:nxt].copy())
            add(0, nxt - pos)
            pos = nxt
            continue
        if sv_idx < len(sv_pos) and pos == sv_pos[sv_idx]:
            carried = sv_gt[sv_idx, hap]
            kind = sv_kind[sv_idx]
            ln = sv_len[sv_idx]
            if carried and kind == 0:          # INS
                seq.append(ref_codes[pos:pos + 1].copy())
                add(0, 1)
                seq.append(ins_seq[sv_idx].copy())
                add(1, ln)
                pos += 1
            elif carried and kind == 1:        # DEL
                seq.append(ref_codes[pos:pos + 1].copy())
                add(0, 1)
                if cfg.split_del_min and -ln >= cfg.split_del_min:
                    # long deletion: the aligner splits the read into two
                    # colinear segments around the missing span
                    close_segment()
                    seg_ref_start = pos + 1 - ln
                    pos = pos + 1 - ln
                else:
                    add(2, -ln)
                    pos += 1 - ln
            elif carried and kind == 2:        # INV: split, middle segment minus
                a, b = pos, pos + ln
                v = min(end_target - a, ln)
                if v >= 30:
                    close_segment()
                    inv_codes = ref_codes[b - v:b].copy()
                    segments.append((None, b - v, 1, [inv_codes], [[0, int(v)]]))
                    if v == ln and end_target > b:
                        seg_ref_start = b
                    pos = b if v == ln else end_target
                else:
                    # read barely enters the inversion (<30bp): emit plain
                    # reference bases — negligible content error at read end
                    upto = min(b, end_target)
                    seq.append(ref_codes[pos:upto].copy())
                    add(0, upto - pos)
                    pos = upto
            elif carried and kind == 3:        # DUP: tandem second pass
                a, b = pos, pos + ln
                # first copy reads as normal reference up to b
                upto = min(b, end_target)
                seq.append(ref_codes[pos:upto].copy())
                add(0, upto - pos)
                pos = upto
                if pos == b and end_target > b:
                    v2 = min(end_target - b, ln)
                    if v2 >= 30:
                        close_segment()
                        segments.append((None, a, 0,
                                         [ref_codes[a:a + v2].copy()],
                                         [[0, int(v2)]]))
                        if v2 == ln:
                            seg_ref_start = b
                            # third segment continues after the dup
                        else:
                            pos = end_target
                    # else: too short, just continue (dup unseen)
            sv_idx += 1
            while snp_idx < len(snp_pos) and snp_pos[snp_idx] < pos:
                snp_idx += 1
            continue
        # SNP site
        base = ref_codes[pos]
        if snp_gt[snp_idx, hap]:
            base = snp_alt[snp_idx]
        seq.append(np.array([base], dtype=np.uint8))
        add(0, 1)
        pos += 1
        snp_idx += 1
    close_segment()

    out = []
    single = len(segments) == 1
    # per-read error multiplier (ONT quality wander): substitutions scale
    # by it and the read's quals shift phred-consistently, so a bad read
    # both errs more and SAYS so — the correlation real basecalls have
    err_mult = float(np.exp(rng.normal(0.0, cfg.read_qual_wander))) \
        if cfg.read_qual_wander > 0 else 1.0
    qual_shift = -10.0 * np.log10(err_mult) if err_mult > 0 else 0.0
    for seg_contig, ref_start, strand, seq_parts, seg_cig in segments:
        codes = np.concatenate(seq_parts) if seq_parts else np.zeros(0, np.uint8)
        codes = _apply_sub_errors(rng, codes, cfg, err_mult)
        quals = np.clip(rng.normal(cfg.qual_mean + qual_shift, 4,
                                   size=len(codes)),
                        5, 40).astype(np.uint8)
        # spurious SV-sized insertion artifacts (single plain segments only;
        # injected BEFORE the small-indel block so both see a valid cigar)
        if single and strand == 0 and seg_contig is None:
            if hotspots is not None and len(hotspots[0]):
                hpos, hlen = hotspots
                ref_span = sum(ln for op, ln in seg_cig if op in (0, 2))
                lo = int(np.searchsorted(hpos, ref_start + 30))
                hi = int(np.searchsorted(hpos, ref_start + ref_span - 30))
                for j in range(lo, hi):
                    if rng.random() < cfg.artifact_hotspot_carry:
                        cut = _query_cut_at(seg_cig, ref_start, int(hpos[j]))
                        if cut is not None and 10 < cut < len(codes) - 10:
                            k = max(int(hlen[j]) + int(rng.integers(-5, 6)),
                                    cfg.artifact_len_min)
                            codes, quals, seg_cig = _inject_ins_artifact(
                                codes, quals, seg_cig, cut, k, rng, cfg)
            if cfg.artifact_ins_rate and len(codes) > 400 \
                    and rng.random() < cfg.artifact_ins_rate:
                cut = int(rng.integers(100, len(codes) - 100))
                k = int(rng.integers(cfg.artifact_len_min,
                                     cfg.artifact_len_max))
                codes, quals, seg_cig = _inject_ins_artifact(
                    codes, quals, seg_cig, cut, k, rng, cfg)
        # small sequencing indels only on single-segment reads (keeps split
        # bookkeeping simple; they never reach SV size anyway)
        if single and rng.random() < cfg.indel_error * 10 and seg_cig \
                and seg_cig[0][1] > 20:
            k = int(rng.integers(1, 4))
            cut = int(rng.integers(5, min(seg_cig[0][1] - 5, 2000)))
            first = seg_cig[0]
            rest = seg_cig[1:]
            if rng.random() < 0.5:
                ins = _rand_codes(rng, k)
                codes = np.concatenate([codes[:cut], ins, codes[cut:]])
                quals = np.concatenate(
                    [quals[:cut], np.full(k, cfg.qual_mean, np.uint8), quals[cut:]])
                seg_cig = [[0, cut], [1, k], [0, first[1] - cut]] + rest
            elif first[1] - cut > k + 5:
                codes = np.concatenate([codes[:cut], codes[cut + k:]])
                quals = np.concatenate([quals[:cut], quals[cut + k:]])
                seg_cig = [[0, cut], [2, k], [0, first[1] - cut - k]] + rest
        # homopolymer-run indels last, on every segment (split reads too)
        codes, quals, seg_cig = _apply_hp_indels(rng, codes, quals, seg_cig,
                                                 cfg, err_mult)
        out.append((seg_contig, ref_start, strand, codes, quals, seg_cig))
    return out


def simulate_dataset(out_dir: str, cfg: SimConfig | None = None):
    """Write <out_dir>/{ref.fa,.fai, reads.bam,.bai, truth.vcf}; returns SimTruth."""
    import os

    cfg = cfg or SimConfig()
    rng = np.random.default_rng(cfg.seed)
    os.makedirs(out_dir, exist_ok=True)

    contig_seqs: dict[str, str] = {}
    truth = SimTruth({}, {}, {}, {}, {}, {}, {}, {}, {}, {})
    contig_codes: dict[str, np.ndarray] = {}
    variants = {}
    for name, length in cfg.contigs.items():
        codes = _rand_codes(rng, length)
        contig_codes[name] = codes
        contig_seqs[name] = decode_bases(codes)
        snp_pos, snp_gt, sv_pos, sv_len, sv_gt, sv_kind, ins_seq = \
            _simulate_variants(rng, length, cfg)
        snp_ref = codes[snp_pos]
        snp_alt = (snp_ref + rng.integers(1, 4, size=len(snp_pos))) % 4
        variants[name] = (snp_pos, snp_gt, snp_alt, sv_pos, sv_len, sv_gt,
                          sv_kind, ins_seq)
        truth.snp_pos[name] = snp_pos
        truth.snp_ref[name] = snp_ref.astype(np.uint8)
        truth.snp_alt[name] = snp_alt.astype(np.uint8)
        truth.snp_gt[name] = snp_gt
        truth.sv_pos[name] = sv_pos
        truth.sv_len[name] = sv_len
        truth.sv_gt[name] = sv_gt
        truth.sv_kind[name] = sv_kind
        truth.sv_ins_seq[name] = ins_seq

    # inter-contig translocation junctions: contig pairs, positions clear of
    # the coarse SV grid; genotype like other SVs (hom_sv_fraction, else het)
    contig_names = list(cfg.contigs)
    if cfg.tra_count and len(contig_names) >= 2:
        for _ in range(cfg.tra_count):
            ia, ib = rng.choice(len(contig_names), size=2, replace=False)
            ca, cb = contig_names[ia], contig_names[ib]
            pa = int(rng.integers(cfg.contigs[ca] // 4, cfg.contigs[ca] * 3 // 4))
            pb = int(rng.integers(cfg.contigs[cb] // 4, cfg.contigs[cb] * 3 // 4))
            gt = np.ones(2, np.int8) if rng.random() < cfg.hom_sv_fraction \
                else np.eye(2, dtype=np.int8)[rng.integers(0, 2)]
            truth.tra.append((ca, pa, cb, pb, gt))

    ref_path = os.path.join(out_dir, "ref.fa")
    write_fasta(ref_path, contig_seqs)

    header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in cfg.contigs.items()
    )
    header = BamHeader(header_text, list(cfg.contigs), list(cfg.contigs.values()))
    bam_path = os.path.join(out_dir, "reads.bam")
    read_counter = 0
    all_records = []
    contig_index = {n: i for i, n in enumerate(cfg.contigs)}
    all_snps = {n: (v[0], v[1], v[2]) for n, v in variants.items()}
    for ref_id, (name, length) in enumerate(cfg.contigs.items()):
        (snp_pos, snp_gt, snp_alt, sv_pos, sv_len, sv_gt, sv_kind,
         ins_seq) = variants[name]
        codes = contig_codes[name]
        tra_here = sorted(
            [(pa, cb, pb, gt) for ca, pa, cb, pb, gt in truth.tra if ca == name],
            key=lambda t: t[0],
        )
        hotspots = None
        if cfg.artifact_hotspots and length > 4000:
            hp = np.sort(rng.integers(1000, length - 1000,
                                      size=cfg.artifact_hotspots))
            hl = rng.integers(cfg.artifact_len_min, cfg.artifact_len_max,
                              size=cfg.artifact_hotspots)
            hotspots = (hp.astype(np.int64), hl.astype(np.int64))
        n_reads = int(cfg.coverage * length / cfg.read_len_mean)
        starts = np.sort(rng.integers(0, max(1, length - 200), size=n_reads))
        spans = (cfg.read_len_mean
                 * np.exp(rng.normal(0, cfg.read_len_sigma, n_reads))).astype(int)
        spans = np.clip(spans, 500, None)
        haps = rng.integers(0, 2, size=n_reads)
        for i in range(n_reads):
            segments = _simulate_read(
                rng, codes, int(starts[i]), int(spans[i]), int(haps[i]),
                snp_pos, snp_gt, snp_alt, sv_pos, sv_len, sv_gt, sv_kind,
                ins_seq, cfg, tra_events=tra_here, all_codes=contig_codes,
                all_snps=all_snps, hotspots=hotspots,
            )
            total = sum(len(s[3]) for s in segments)
            if total < 200 or not segments:
                continue
            rname = f"read_{read_counter}"
            read_counter += 1
            truth.read_hap[rname] = int(haps[i])
            primary = max(range(len(segments)), key=lambda k: len(segments[k][3]))
            # forward-read query offsets per segment (read order)
            q_off = np.cumsum([0] + [len(s[3]) for s in segments])
            L = int(q_off[-1])
            for k, (seg_contig, ref_start, strand, seg_codes, seg_quals,
                    seg_cig) in enumerate(segments):
                qs, qe = int(q_off[k]), int(q_off[k + 1])
                # stored-orientation hard clips: a minus-strand record's
                # stored sequence is reference-forward, i.e. the read's
                # reverse complement — clips swap ends
                lead = (L - qe) if strand else qs
                trail = qs if strand else (L - qe)
                cig_full = []
                if lead:
                    cig_full.append([5, lead])
                cig_full.extend(seg_cig)
                if trail:
                    cig_full.append([5, trail])
                flag = (0x10 if strand else 0) | (0 if k == primary else 0x800)
                seg_rid = ref_id if seg_contig is None \
                    else contig_index[seg_contig]
                all_records.append((seg_rid, int(ref_start), BamRead(
                    rname, flag, seg_rid, int(ref_start), 60,
                    np.array(cig_full, dtype=np.int32),
                    seg_codes, seg_quals, {},
                )))
    all_records.sort(key=lambda t: (t[0], t[1]))
    with BamWriter(bam_path, header) as w:
        for _, _, rec in all_records:
            w.write(rec)
    write_bam_index(bam_path)

    _write_truth_vcf(os.path.join(out_dir, "truth.vcf"), cfg, truth)
    return truth


def _write_truth_vcf(path: str, cfg: SimConfig, truth: SimTruth) -> None:
    header = [
        "##fileformat=VCFv4.2",
        "##source=duet_tpu.sim",
    ] + [f"##contig=<ID={n},length={l}>" for n, l in cfg.contigs.items()] + [
        '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="SV length">',
        '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="SV type">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Phased genotype">',
        '##FORMAT=<ID=PS,Number=1,Type=String,Description="Phase set">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE",
    ]
    kind_names = ("INS", "DEL", "INV", "DUP")
    records = []
    for name in truth.sv_pos:
        for i, (p, l, gt, k) in enumerate(
            zip(truth.sv_pos[name], truth.sv_len[name], truth.sv_gt[name],
                truth.sv_kind[name])
        ):
            svtype = kind_names[int(k)]
            gts = f"{gt[0]}|{gt[1]}"
            records.append(
                f"{name}\t{p + 1}\ttruth.{name}.{i}\tN\t<{svtype}>\t.\tPASS\t"
                f"SVLEN={l};SVTYPE={svtype}\tGT:PS\t{gts}:1"
            )
    # translocation junctions: a mated breakend record per side.  Reads
    # retain [start, pa) on contig A, so the 'L'-side breakend sits ON the
    # last retained base pa-1 (1-based: pa); the 'R' side starts AT pb
    # (1-based: pb+1) — VCF breakend convention
    for i, (ca, pa, cb, pb, gt) in enumerate(truth.tra):
        gts = f"{gt[0]}|{gt[1]}"
        records.append(
            f"{ca}\t{pa}\ttruth.BND.{i}.1\tN\tN[{cb}:{pb + 1}[\t.\tPASS\t"
            f"SVTYPE=BND;CHR2={cb};END={pb + 1};MATEID=truth.BND.{i}.2\t"
            f"GT:PS\t{gts}:1"
        )
        records.append(
            f"{cb}\t{pb + 1}\ttruth.BND.{i}.2\tN\t]{ca}:{pa}]N\t.\tPASS\t"
            f"SVTYPE=BND;CHR2={ca};END={pa};MATEID=truth.BND.{i}.1\t"
            f"GT:PS\t{gts}:1"
        )
    write_vcf(path, header, records)
