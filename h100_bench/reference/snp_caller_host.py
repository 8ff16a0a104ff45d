# A frozen copy of duet_tpu_torch/models/snp_caller_host.py for the benchmark's plain
# reference: imports point into h100_bench.reference; the native and
# device routes, and what the reference never calls, are taken out.
"""The host half of ``duet_tpu.models.snp_caller``, copied for the port.

The functions, classes and constants that the port's stage code uses, and
what they call, verbatim but for their imports.

Pileup SNP caller — the framework's SNP-calling stage.

Stands in for the reference's external Clair3 invocation in pileup-only,
call-snp-only mode (reference src/duet/snp_calling.py:13-17): the downstream
contract is just a VCF of SNP sites with genotypes at min allele frequency
`maf`, which a counting pileup provides directly.  Counting is one
scatter-add over (position, base) pairs — the JAX/TPU formulation in
duet_tpu.ops.pileup; this module hosts the numpy path plus site calling and
pileup.vcf.gz emission.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from h100_bench.reference.readstore import ContigReads
from h100_bench.reference.vcf import write_vcf


BASES = "ACGT"


@dataclass
class SnpCallConfig:
    min_af: float = 0.25          # reference -m / --snp_min_af default
    min_depth: int = 4
    min_alt_reads: int = 3        # binomial-error floor: with per-base error
                                  # ~2% an AF cut alone admits 2-error-read
                                  # false hets at low coverage (hundreds per
                                  # Mb at 8-10x), poisoning phasing evidence;
                                  # 3+ reads makes that P(X>=3|n=10) ~ 4e-5
    hom_af: float = 0.75          # alt fraction above which a site is hom-alt
    min_base_qual: int = 10
    min_mapq: int = 10
    model: str = "counts"         # "counts" (exact-rational rule) | "nn"
                                  # (neural pileup caller, models/nn_snp.py —
                                  # the MXU analogue of Clair3's pileup net)
    device: bool = False          # route counting + site calling through the
                                  # jitted device kernel (duet_tpu.ops.pileup)
                                  # — bit-identical to the host path (exact
                                  # integer AF cuts); the pipeline enables it
                                  # when an accelerator backend is live


@dataclass
class ContigSnps:
    """Called SNP sites of one contig (0-based positions)."""

    contig: str
    pos: np.ndarray       # (m,) int64
    ref_code: np.ndarray  # (m,) uint8
    alt_code: np.ndarray  # (m,) uint8
    is_het: np.ndarray    # (m,) bool
    depth: np.ndarray     # (m,) int32
    alt_count: np.ndarray # (m,) int32


def match_op_table(cr: ContigReads, min_mapq: int):
    """Per-op (ref_start, query_start, length, read_index) int64 arrays for
    every aligned-match (M/=/X) cigar op passing the mapq cut — the compact
    per-op form of the observation stream (one row per op, ~100x fewer rows
    than per-base expansion).  Vectorized over the flat cigar arrays:
    per-op ref/query positions come from exclusive scans reset at read
    starts; no per-read Python loop."""
    ops = cr.cigar_ops.astype(np.int64)
    lens = cr.cigar_lens.astype(np.int64)
    n_ops = len(ops)
    z = np.zeros(0, dtype=np.int64)
    if n_ops == 0:
        return z, z, z, z

    op_read = np.repeat(np.arange(cr.n, dtype=np.int64),
                        np.diff(cr.cigar_off).astype(np.int64))
    start_of_read = cr.cigar_off[:-1]
    first = np.minimum(start_of_read, n_ops - 1)

    ref_adv = np.where((ops == 0) | (ops == 2) | (ops == 3)
                       | (ops == 7) | (ops == 8), lens, 0)
    ref_cum = np.cumsum(ref_adv) - ref_adv
    op_ref = cr.starts[op_read] + (ref_cum - ref_cum[first][op_read])

    q_adv = np.where((ops == 0) | (ops == 1) | (ops == 4)
                     | (ops == 7) | (ops == 8), lens, 0)
    q_cum = np.cumsum(q_adv) - q_adv
    op_q = cr.seq_off[op_read] + (q_cum - q_cum[first][op_read])

    is_match = ((ops == 0) | (ops == 7) | (ops == 8)) & \
        (cr.mapq[op_read] >= min_mapq) & (lens > 0)
    return (op_ref[is_match], op_q[is_match], lens[is_match],
            op_read[is_match])


def pileup_observations(cr: ContigReads, cfg: SnpCallConfig):
    """Flatten all aligned (M/=/X) bases of a contig into parallel arrays
    (ref_pos, base_code, qual, read_index) — the scatter feed for counting
    and the gather feed for the allele matrix.

    Fully vectorized: the per-op table (match_op_table) expands to per-base
    rows with one grouped arange — no per-read Python loop."""
    empty = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint8),
             np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int32))
    op_ref_m, op_q_m, m_lens, op_read_m = match_op_table(cr, cfg.min_mapq)
    if len(m_lens) == 0:
        return empty
    total = int(m_lens.sum())
    # grouped arange: per-base offset within its op. int32 halves memory
    # traffic on the hot path; fall back to int64 when a contig's matched
    # bases or sequence bytes could overflow (chr1-scale deep coverage)
    idx_t = np.int32 if max(total, len(cr.seq)) < 2**31 else np.int64
    boundary = (np.cumsum(m_lens) - m_lens).astype(np.int64)
    within = np.arange(total, dtype=idx_t) - np.repeat(
        boundary, m_lens).astype(idx_t)
    positions = np.repeat(op_ref_m.astype(idx_t), m_lens) + within
    qidx = np.repeat(op_q_m.astype(idx_t), m_lens) + within
    read_idx = np.repeat(op_read_m, m_lens).astype(np.int32)
    return positions, cr.seq[qidx], cr.qual[qidx], read_idx


def filter_observations_to_sites(positions, bases, quals, read_idx,
                                 site_pos: np.ndarray):
    """Keep only observations landing on `site_pos` (sorted). The SNP stage
    computes the full observation stream once; this small slice is all the
    phasing stage's allele matrix needs — no second pileup pass."""
    j = np.searchsorted(site_pos, positions)
    m = len(site_pos)
    ok = j < m
    jc = np.minimum(j, max(m - 1, 0))
    at = ok & (site_pos[jc] == positions) if m else np.zeros(len(positions), bool)
    return positions[at], bases[at], quals[at], read_idx[at]


def count_alleles(positions, bases, quals, length: int, min_base_qual: int) -> np.ndarray:
    """(L, 4) allele counts; N bases and low-qual bases are dropped.

    An observation at or beyond `length` means a read extends past the
    contig end (malformed input); fail loudly — the native twin
    (io.native_ingest.pileup_counts_native) applies the same check so the
    two backends never silently diverge."""
    keep = (bases < 4) & (quals >= min_base_qual)
    pos_kept = positions[keep]
    if len(pos_kept) and int(pos_kept.max()) >= length:
        raise ValueError(
            f"pileup observation at position {int(pos_kept.max())} beyond "
            f"contig length {length}: read alignment extends past the "
            "contig end (malformed BAM/FASTA pair)"
        )
    dtype = np.int64 if length * 4 >= 2**31 else np.int32
    key = pos_kept.astype(dtype) * 4 + bases[keep]
    return np.bincount(key, minlength=length * 4).reshape(length, 4)


def _as_rational(x: float) -> tuple[int, int]:
    from fractions import Fraction

    f = Fraction(x).limit_denominator(10_000)
    return f.numerator, f.denominator


def call_snps(contig: str, counts: np.ndarray, ref_codes: np.ndarray,
              cfg: SnpCallConfig) -> ContigSnps:
    """Frequency-based site calling over the (L,4) count matrix.

    Allele-frequency cuts are evaluated in exact integer form
    (alt * den >= depth * num) — identical on the device path
    (duet_tpu.ops.pileup.call_sites).

    Two-phase for chromosome-scale L: a cheap pre-filter on total non-ref
    evidence (a SUPERSET of the exact cuts: total non-ref >= the argmax
    allele's count) selects candidate rows, and the per-allele argmax work
    runs only on those."""
    ref_safe = np.minimum(ref_codes, 3).astype(np.int64)
    depth_all = counts.sum(axis=1)
    ref_count = np.take_along_axis(counts, ref_safe[:, None], axis=1)[:, 0]
    nonref_total = depth_all - ref_count
    cand = np.flatnonzero(
        (depth_all >= cfg.min_depth)
        & (nonref_total >= cfg.min_alt_reads)
        & (ref_codes < 4)
    )
    sub = counts[cand].copy()
    m = len(cand)
    sub[np.arange(m), ref_safe[cand]] = -1
    alt_code = sub.argmax(axis=1)
    alt_count = counts[cand, alt_code]
    depth = depth_all[cand]
    ref_safe_c = ref_safe[cand]
    af_num, af_den = _as_rational(cfg.min_af)
    hom_num, hom_den = _as_rational(cfg.hom_af)
    keep = (
        (alt_count * af_den >= depth * af_num)
        & (alt_count >= cfg.min_alt_reads)
        & (alt_code != ref_safe_c)
    )
    pos = cand[keep].astype(np.int64)
    alt_code = alt_code[keep]
    alt_count = alt_count[keep]
    depth = depth[keep]
    return ContigSnps(
        contig=contig,
        pos=pos,
        ref_code=ref_codes[pos].astype(np.uint8),
        alt_code=alt_code.astype(np.uint8),
        is_het=alt_count * hom_den < depth * hom_num,
        depth=depth.astype(np.int32),
        alt_count=alt_count.astype(np.int32),
    )


# --snp-model auto policy, from the measured coverage x error grid
# (README "SNP model head-to-head", tools/snp_grid.py): the neural caller
# beats the exact-rational counting rule only in the high-error regime
# (>=5% substitutions) at workable coverage (>=8x); everywhere else the
# counting rule's tuned min-alt floor wins or ties.  The thresholds sit at
# the measured boundary midpoints.
AUTO_NN_MIN_ERR = 0.035   # observed non-ref fraction (error + ~0.1% variants)

AUTO_NN_MIN_COV = 7.0     # mean depth


def choose_snp_model(counts: np.ndarray, ref_codes: np.ndarray) -> str:
    """Pick counts/nn from the data itself: the (L,4) count image gives the
    observed substitution rate (non-reference observation fraction — true
    variants contribute ~0.1% at human densities, sequencing error 1-15%)
    and the mean coverage, the two axes of the measured decision grid.

    Estimated on a deterministic row stride: the decision needs ~2
    significant digits of a rate averaged over millions of positions, and
    full-image reductions cost real time at chromosome L (the (L,4) image
    is gigabytes)."""
    L = len(ref_codes)
    stride = max(L // 2_000_000, 1)
    c = counts[::stride]
    r = ref_codes[::stride]
    # restrict BOTH sums to ACGT-reference rows: coverage over N gaps /
    # padded stretches has no defined substitution rate, and counting it
    # only in the denominator would inflate `err` (both callers skip
    # ref>=4 sites too)
    ok = np.flatnonzero(r < 4)
    total = int(c[ok].sum(dtype=np.int64))
    if total == 0:
        return "counts"
    ref_sum = int(c[ok, r[ok]].sum(dtype=np.int64))
    err = 1.0 - ref_sum / total
    cov = total / max(len(ok), 1)
    return "nn" if (err >= AUTO_NN_MIN_ERR and cov >= AUTO_NN_MIN_COV) \
        else "counts"


def pileup_with_counts(cr: ContigReads, cfg: SnpCallConfig, length: int):
    """(obs, (L, 4) counts): the numpy scans and a bincount."""
    obs = pileup_observations(cr, cfg)
    return obs, count_alleles(obs[0], obs[1], obs[2], length,
                              cfg.min_base_qual)


def write_pileup_vcf(path: str, snps: dict[str, ContigSnps],
                     contig_lengths: dict[str, int]) -> None:
    """pileup.vcf(.gz) in the shape downstream stages consume
    (mirrors the artifact contract of reference snp_calling.py:11)."""
    header = [
        "##fileformat=VCFv4.2",
        "##source=duet_tpu.snp_caller",
    ] + [
        f"##contig=<ID={c},length={contig_lengths.get(c, 0)}>" for c in snps
    ] + [
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Depth">',
        '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allele depths">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE",
    ]
    records = []
    for contig, s in snps.items():
        for k in range(len(s.pos)):
            gt = "0/1" if s.is_het[k] else "1/1"
            records.append(
                f"{contig}\t{s.pos[k] + 1}\t.\t{BASES[s.ref_code[k]]}\t"
                f"{BASES[s.alt_code[k]]}\t{s.alt_count[k]}\tPASS\t.\t"
                f"GT:DP:AD\t{gt}:{s.depth[k]}:"
                f"{s.depth[k] - s.alt_count[k]},{s.alt_count[k]}"
            )
    write_vcf(path, header, records)


def read_pileup_vcf(path: str) -> dict[str, ContigSnps]:
    """Inverse of write_pileup_vcf, for resume-from-artifacts.

    FORMAT-aware, so a REAL Clair3 pileup.vcf.gz dropped into
    snp_calling/ works as a --resume input too (Clair3 emits e.g.
    GT:GQ:DP:AF — reference snp_calling.py:13-17's artifact): genotype
    phasedness separators both accepted, depth from DP or AD, alt count
    from AD, else round(AF*DP), else a het/hom-consistent fallback.
    Multi-allelic ALTs keep their first allele (the downstream contract is
    one alt per site, as in the counting caller)."""
    from h100_bench.reference.vcf import open_maybe_gzip

    code = {b: i for i, b in enumerate(BASES)}
    per: dict[str, list] = {}
    with open_maybe_gzip(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.split()
            if len(cols) < 10:
                continue
            ref = cols[3][:1].upper()
            alt = cols[4].split(",")[0][:1].upper()
            if len(cols[3]) != 1 or len(cols[4].split(",")[0]) != 1:
                continue  # indel record: not a pileup SNP site
            fmap = dict(zip(cols[8].split(":"), cols[9].split(":")))
            gt = fmap.get("GT", "0/1").replace("|", "/")
            if gt in ("0/0", "./.", "."):
                continue
            # het = two distinct alleles, including multi-allelic hets like
            # Clair3's 1/2 (neither allele is the ref); only a genuinely
            # homozygous-alt GT (1/1) resumes as hom
            is_het = len(set(gt.split("/"))) > 1
            depth = 0
            if fmap.get("DP", ".").isdigit():
                depth = int(fmap["DP"])
            ad = fmap.get("AD", "")
            alt_count = 0
            if "," in ad:
                parts = ad.split(",")
                if parts[1].replace(".", "").isdigit() and parts[1] != ".":
                    alt_count = int(parts[1])
                    if depth == 0:
                        depth = sum(int(p) for p in parts if p.isdigit())
            if alt_count == 0:
                af = fmap.get("AF", "")
                try:
                    alt_count = int(round(float(af) * depth))
                except ValueError:
                    alt_count = depth // 2 if is_het else depth
            per.setdefault(cols[0], []).append((
                int(cols[1]) - 1, code.get(ref, 4), code.get(alt, 4),
                is_het, depth, alt_count,
            ))
    out = {}
    for contig, rows in per.items():
        a = list(zip(*rows))
        out[contig] = ContigSnps(
            contig,
            np.array(a[0], dtype=np.int64),
            np.array(a[1], dtype=np.uint8),
            np.array(a[2], dtype=np.uint8),
            np.array(a[3], dtype=bool),
            np.array(a[4], dtype=np.int32),
            np.array(a[5], dtype=np.int32),
        )
    return out
