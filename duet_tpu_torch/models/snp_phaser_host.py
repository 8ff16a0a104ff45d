"""The host half of ``duet_tpu.models.snp_phaser``, copied for the port.

The functions, classes and constants that the port's stage code uses, and
what they call, verbatim but for their imports.

SNP phasing + per-read haplotagging — the framework's phasing stage.

Replaces the reference's external WhatsHap invocations (`whatshap phase` +
`whatshap haplotag`, reference src/duet/snp_phasing.py:22-29) with an
in-framework algorithm designed around a TPU-friendly formulation:

  A : (reads x het-sites) allele matrix, A[r,j] = +1 (read shows alt),
      -1 (read shows ref), 0 (site not covered) — weighted by base quality.

  *Phasing* finds per-site phase[j] in {+1,-1} ("alt on hap1"/"alt on hap2");
  *haplotagging* assigns each read hap_r = sign(A @ phase).  Both are steps
  of the same rank-1 power iteration on A (site update: phase = sign(A^T h);
  read update: h = sign(A phase)) — i.e. repeated matvecs/matmuls, which is
  exactly what the MXU wants.  The initial iterate comes from adjacent-site
  cis/trans vote chaining, which also delimits phase-set blocks (PS):
  consecutive het sites sharing no read start a new block, PS = 1-based
  position of the block's first site (WhatsHap's PS convention).

Per-read outputs mirror the HP/PC/PS tags the reference consumes
(sv_phasing_fn.py:26-29): HP in {1,2}; PS; and PC — a phasing confidence.
The decision stage treats per-read PC sums as *evidence magnitude* (side
with avg PC > 0 wins a het call; `onehap_totsc != 0` means evidence on
exactly one haplotype; thresholds 1369.50 / 2400 / 9.72 operate on PC means
and ratios — sv_phasing_fn.py:112-183), so PC must be strictly positive for
a tagged read and land on the same hundreds-to-thousands scale as WhatsHap's
phasing-cost margins.  Definition here: PC = clip(round(10 * margin), 1,
8100) where margin is the quality-weighted site-agreement surplus of the
assigned haplotype over the other.  Capping at 8100 means every tagged read
passes the decision stage's `pc <= 8100` evidence cut (sv_phasing_fn.py:76)
— the cut's exclusion role applies to WhatsHap's uncapped outliers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from duet_tpu_torch.io.readstore import ContigReads
from duet_tpu_torch.models.snp_caller_host import (
    ContigSnps,
    SnpCallConfig,
    pileup_observations,
)
from duet_tpu_torch.utils.spans import span


PC_PER_MARGIN = 10   # phred-like scale: PC = 10 * quality-weighted margin

PC_MAX = 8100        # cap = the decision stage's evidence cut

REFINE_CORRECT_ROUNDS = 4  # refine<->switch-correct fixed-point cap


@dataclass
class AlleleMatrix:
    """Sparse COO (reads x het sites) allele observations for one contig.

    A row is one READ (by name): split alignments pool their segments'
    observations into a single row, so a read crossing an SV breakpoint
    still bridges phase blocks and haplotags on its combined evidence."""

    n_reads: int
    n_sites: int
    site_pos: np.ndarray   # (m,) int64 0-based positions of het sites
    row: np.ndarray        # (nnz,) int32 read (name-group) index
    col: np.ndarray        # (nnz,) int32 site index
    allele: np.ndarray     # (nnz,) int8 +1 alt / -1 ref
    weight: np.ndarray     # (nnz,) float32 base-quality weight
    row_names: list | None = None  # (n_reads,) read names, index-aligned


@dataclass
class PhaseResult:
    """Per-site phasing + per-read haplotags for one contig."""

    site_pos: np.ndarray    # (m,) int64
    phase: np.ndarray       # (m,) int8 +1 alt-on-hap1 / -1 alt-on-hap2 / 0 unphased
    block_id: np.ndarray    # (m,) int32 phase-set block index, -1 unphased
    block_ps: np.ndarray    # (nblocks,) int64 PS value (1-based pos of first site)
    read_hap: np.ndarray    # (n_reads,) int8 1/2, 0 untagged
    read_ps: np.ndarray     # (n_reads,) int64 PS of assigned block, -1 untagged
    read_pc: np.ndarray     # (n_reads,) int32 phasing cost, -1 untagged
    row_names: list | None = None  # read names, index-aligned with read_*


def build_allele_matrix(cr: ContigReads, snps: ContigSnps,
                        cfg: SnpCallConfig | None = None,
                        obs=None) -> AlleleMatrix:
    """Intersect every aligned base with the het-SNP site list.

    `obs` may carry a precomputed (positions, bases, quals, read_idx)
    observation stream (already restricted to SNP sites or not) from the
    SNP-calling stage; otherwise the stream is rebuilt from the reads."""
    cfg = cfg or SnpCallConfig()
    het = np.flatnonzero(snps.is_het)
    site_pos = snps.pos[het]
    ref_c = snps.ref_code[het]
    alt_c = snps.alt_code[het]
    m = len(site_pos)

    # rows are name groups: split alignments of one read share a row
    gid_of: dict[str, int] = {}
    gid = np.empty(cr.n, dtype=np.int32)
    row_names: list[str] = []
    for i, name in enumerate(cr.names):
        g = gid_of.get(name)
        if g is None:
            g = gid_of[name] = len(row_names)
            row_names.append(name)
        gid[i] = g
    n_rows = len(row_names)

    if m == 0 or cr.n == 0:
        z = np.zeros(0, dtype=np.int32)
        return AlleleMatrix(n_rows, 0, site_pos, z, z,
                            z.astype(np.int8), z.astype(np.float32),
                            row_names=row_names)

    if obs is None:
        # no precomputed stream (e.g. --resume from a pileup artifact):
        # extract just the at-site observations natively when possible —
        # the full per-base stream never materializes
        try:
            from duet_tpu_torch.io.native_ingest import pileup_obs_native

            obs, _ = pileup_obs_native(cr, cfg.min_mapq, site_pos=site_pos)
        except Exception:
            obs = pileup_observations(cr, cfg)
    positions, bases, quals, read_idx = obs
    read_idx = gid[read_idx]
    j = np.searchsorted(site_pos, positions)
    j_ok = (j < m)
    j_clip = np.minimum(j, m - 1)
    at_site = j_ok & (site_pos[j_clip] == positions)
    j = j_clip[at_site]
    b = bases[at_site]
    q = quals[at_site]
    r = read_idx[at_site]
    is_alt = b == alt_c[j]
    is_ref = b == ref_c[j]
    informative = (is_alt | is_ref) & (q >= cfg.min_base_qual)
    return AlleleMatrix(
        n_reads=n_rows,
        n_sites=m,
        site_pos=site_pos,
        row=r[informative].astype(np.int32),
        col=j[informative].astype(np.int32),
        allele=np.where(is_alt[informative], 1, -1).astype(np.int8),
        weight=np.minimum(q[informative], 40).astype(np.float32),
        row_names=row_names,
    )


def _adjacent_link_votes(am: AlleleMatrix):
    """For each consecutive site pair (j, j+1): quality-weighted cis minus
    trans evidence from reads covering both, and the total link count."""
    m = am.n_sites
    cis = np.zeros(max(m - 1, 0), dtype=np.float64)
    links = np.zeros(max(m - 1, 0), dtype=np.int64)
    if m < 2 or len(am.row) == 0:
        return cis, links
    order = np.lexsort((am.col, am.row))
    r, c = am.row[order], am.col[order]
    a, w = am.allele[order], am.weight[order]
    adj = (r[1:] == r[:-1]) & (c[1:] == c[:-1] + 1)
    pair_j = c[:-1][adj]
    signed = (a[1:] * a[:-1])[adj] * np.minimum(w[1:], w[:-1])[adj]
    np.add.at(cis, pair_j, signed)
    np.add.at(links, pair_j, 1)
    return cis, links


def _initial_phase(am: AlleleMatrix):
    """Chain phasing: phase[0]=+1 per block; each next site's phase flips when
    trans evidence outweighs cis.

    Block boundaries come from interval-stabbing connectivity: sites j-1 and
    j stay in one block when ANY read covers sites on both sides of the
    boundary — adjacency is not required (a read may skip a site it covers
    with a low-quality base).  Boundaries that are bridged but carry no
    adjacent-pair vote start with unknown relative phase (+1); the
    switch-error corrector then settles the orientation from the full
    spanning evidence."""
    m = am.n_sites
    phase = np.zeros(m, dtype=np.int8)
    block_id = np.full(m, -1, dtype=np.int32)
    if m == 0:
        return phase, block_id, np.zeros(0, dtype=np.int64)
    cis, links = _adjacent_link_votes(am)
    covered = np.zeros(m, dtype=bool)
    if len(am.col):
        covered[np.unique(am.col)] = True
    # reads spanning the boundary between sites j-1 and j: first covered
    # site <= j-1 and last covered site >= j
    new_block = np.ones(m, dtype=bool)
    if len(am.row):
        first = np.full(am.n_reads, m, dtype=np.int64)
        last = np.full(am.n_reads, -1, dtype=np.int64)
        np.minimum.at(first, am.row, am.col)
        np.maximum.at(last, am.row, am.col)
        spans = last > first
        diff = np.zeros(m + 1, dtype=np.int64)
        np.add.at(diff, first[spans], 1)
        np.add.at(diff, last[spans], -1)
        boundary_cov = np.cumsum(diff)[:m]
        new_block[1:] = boundary_cov[:-1] == 0
    bid = np.cumsum(new_block) - 1
    # phase = running parity of rel within the block
    rel = np.ones(m, dtype=np.int8)
    rel[1:] = np.where(cis >= 0, 1, -1)
    rel[new_block] = 1
    flip = np.cumsum(rel < 0)  # count of flips up to and incl. j
    # parity within block: flips since block start
    block_start_flip = flip.copy()
    starts = np.flatnonzero(new_block)
    block_start_flip = flip[starts][bid]
    phase = np.where((flip - block_start_flip) % 2 == 0, 1, -1).astype(np.int8)
    phase[~covered] = 0
    block_id = np.where(covered, bid, -1).astype(np.int32)
    # PS per block: 1-based position of first covered site in block
    nblocks = int(bid[-1]) + 1
    block_ps = np.zeros(nblocks, dtype=np.int64)
    cov_idx = np.flatnonzero(covered)
    if len(cov_idx):
        blocks, first = np.unique(bid[cov_idx], return_index=True)
        block_ps[blocks] = am.site_pos[cov_idx[first]] + 1
    return phase, block_id, block_ps


def _block_obs_groups(am: AlleleMatrix, block_id: np.ndarray):
    """Per-block observation tables for the boundary-evidence machinery:
    yields (b, cols_b, rows, lj, base_v, start_idx, seg) with observations
    sorted by (read, local site) and read segments delimited."""
    obs_block = block_id[am.col]
    obs_order = np.argsort(obs_block, kind="stable")
    obs_block_sorted = obs_block[obs_order]
    for b in np.unique(block_id[block_id >= 0]):
        cols_b = np.flatnonzero(block_id == b)
        if len(cols_b) < 2:
            continue
        s0 = int(np.searchsorted(obs_block_sorted, b, "left"))
        s1 = int(np.searchsorted(obs_block_sorted, b, "right"))
        sel = obs_order[s0:s1]
        if len(sel) == 0:
            continue
        lj = np.searchsorted(cols_b, am.col[sel])
        rows = am.row[sel]
        base_v = am.allele[sel].astype(np.float64) * am.weight[sel]
        order = np.lexsort((lj, rows))
        rows, lj, base_v = rows[order], lj[order], base_v[order]
        read_start = np.ones(len(rows), dtype=bool)
        read_start[1:] = rows[1:] != rows[:-1]
        start_idx = np.flatnonzero(read_start)
        seg = np.cumsum(read_start) - 1  # compact read index
        yield int(b), cols_b, rows, lj, base_v, start_idx, seg


def _spanning_products(phase, cols_b, rows, lj, base_v, start_idx, seg):
    """Shared event-scan core of _boundary_E/_boundary_stats: for every
    entry k that has a successor in the same read (so the read spans the
    boundaries (lj_k, lj_{k+1}]), the read's signed left/right partial
    sums around that gap, via one O(nnz) prefix scan.  Returns (k, L, R)."""
    v = base_v * phase[cols_b[lj]]
    cum = np.cumsum(v)
    seg_offset = np.concatenate([[0.0], cum[start_idx[1:] - 1]]) \
        if len(start_idx) > 1 else np.zeros(1)
    P = cum - seg_offset[seg]          # prefix INCLUDING current entry
    S = np.add.reduceat(v, start_idx)  # per-read total
    has_next = np.zeros(len(rows), dtype=bool)
    has_next[:-1] = rows[1:] == rows[:-1]
    k = np.flatnonzero(has_next)
    return k, P[k], S[seg[k]] - P[k]


def _accumulate_boundaries(m, lj, k, vals):
    """Range-add each vals row over its spanning boundaries (lj_k, lj_{k+1}]
    (difference array + cumsum); one output row per input row, length m-1."""
    out = np.zeros((len(vals), m + 1))
    for row, val in enumerate(vals):
        np.add.at(out[row], lj[k] + 1, val)
        np.add.at(out[row], lj[k + 1] + 1, -val)
    return np.cumsum(out, axis=1)[:, 1:m]


def _boundary_E(phase, cols_b, rows, lj, base_v, start_idx, seg):
    """E_j = sum over reads of L_r(j)*R_r(j) for every boundary of one
    block under the given phase; E[j-1] is the evidence for the boundary
    before local site j."""
    k, left, right = _spanning_products(phase, cols_b, rows, lj, base_v,
                                        start_idx, seg)
    return _accumulate_boundaries(len(cols_b), lj, k, [left * right])[0]


def _switch_correct(am: AlleleMatrix, phase: np.ndarray, block_id: np.ndarray,
                    max_flips: int = 50) -> np.ndarray:
    """Repair switch errors: whole-suffix phase flips inside a block.

    Site-wise majority refinement cannot fix a run of sites that is
    collectively flipped (each side outvotes the boundary-spanning reads
    locally), so evaluate every possible switch point directly via
    _boundary_E: a flipped suffix makes spanning reads' L and R disagree in
    sign, so E_j < 0; flipping the suffix at argmin E_j raises the global
    objective sum_r (L_r + R_r)^2 by -4*E_j > 0, hence the loop
    terminates."""
    phase = phase.copy()
    for b, cols_b, rows, lj, base_v, start_idx, seg in \
            _block_obs_groups(am, block_id):
        for _ in range(max_flips):
            E = _boundary_E(phase, cols_b, rows, lj, base_v, start_idx, seg)
            if len(E) == 0:
                break
            jmin = int(np.argmin(E))
            if E[jmin] >= 0:
                break
            phase[cols_b[jmin + 1:]] *= -1
    return phase


def _boundary_stats(phase, cols_b, rows, lj, base_v, start_idx, seg):
    """Per-boundary (E, M, N) for one block under the given phase:

      E_j = sum_r L_r R_r        signed junction evidence (what the
                                 corrector maximizes; >= 0 at convergence)
      M_j = sum_r |L_r| |R_r|    total spanning magnitude — the evidence the
                                 junction WOULD have if every spanning read
                                 agreed; scales with local coverage
      N_j = #{r spanning j}      spanning read count

    E/M in [-1, 1] is a coverage-free agreement ratio; M/N is the typical
    per-read product scale.  Same event-scan core as _boundary_E."""
    k, left, right = _spanning_products(phase, cols_b, rows, lj, base_v,
                                        start_idx, seg)
    E, M, N = _accumulate_boundaries(
        len(cols_b), lj, k,
        [left * right, np.abs(left) * np.abs(right), np.ones(len(k))])
    return E, M, N


def _junction_evidence(am: AlleleMatrix, phase: np.ndarray,
                       block_id: np.ndarray):
    """Converged per-boundary junction statistics (E is the exact quantity
    _switch_correct minimizes; at convergence all E_j >= 0 and small values
    mean the two sides are barely coupled).  Returns
    {block: (cols_b, E, M, N)} per _boundary_stats."""
    return {
        b: (cols_b, *_boundary_stats(phase, cols_b, rows, lj, base_v,
                                     start_idx, seg))
        for b, cols_b, rows, lj, base_v, start_idx, seg in
        _block_obs_groups(am, block_id)
    }


# adaptive weak-junction criterion (tuned on truth-labeled junctions,
# tools/junction_diag.py; see docs/PC_SCALE.md): a junction splits when its
# converged evidence is an outlier vs the block's own median (coverage-
# relative, no absolute scale) AND the local spanning reads either disagree
# (agreement ratio E/M below ADAPTIVE_RHO — conflicting evidence cannot pin
# the orientation) or amount to at most one read (ADAPTIVE_N1 — one read's
# word, unverifiable)
ADAPTIVE_REL = 20.0   # split only if E < block median E / this

ADAPTIVE_RHO = 0.8    # ...and agreement ratio below this

ADAPTIVE_N1 = True    # ...or spanning-read count <= 1


def support_read_intervals(cr: ContigReads, names: set):
    """Name-grouped reference spans of the given reads, as a
    (sorted_starts, prefix_max_ends) pair for O(log n) junction queries —
    or None when no read matches.  Split alignments of one name share a
    pooled span, matching the allele matrix's name-grouped rows.

    Deliberately a set-membership loop: np.isin on OBJECT (string) arrays
    degenerates to per-candidate full-column comparisons and measured
    127 s where this loop takes 0.19 s on a 183k-alignment x 70k-name
    production contig (round-5 measurement — the "vectorized" rewrite
    suggested by the round-4 advisor was a 680x regression and is
    reverted).  Hashing each name once against a set is O(n) with small
    constants; at 1M alignments this is ~1 s host-side, far below the
    stage's kernel work."""
    spans: dict[str, list] = {}
    for i, nm in enumerate(cr.names):
        if nm in names:
            s = spans.get(nm)
            if s is None:
                spans[nm] = [int(cr.starts[i]), int(cr.ends[i])]
            else:
                s[0] = min(s[0], int(cr.starts[i]))
                s[1] = max(s[1], int(cr.ends[i]))
    if not spans:
        return None
    arr = np.array(sorted(spans.values()), dtype=np.int64)
    return arr[:, 0], np.maximum.accumulate(arr[:, 1])


def _junction_protected(protect, p_lo: np.ndarray, p_hi: np.ndarray):
    """True where some protected interval [a, b) spans the junction gap
    (a <= p_lo and b > p_hi): an SV support read bridges the two sides, so
    splitting there would push the call into the conservative two-PS
    decision regime (reference sv_phasing_fn.py:86-105) and cost
    calling/genotyping recall for no phasing-precision gain."""
    starts, max_end = protect
    idx = np.searchsorted(starts, p_lo, "right") - 1
    return (idx >= 0) & (max_end[np.maximum(idx, 0)] > p_hi)


def _split_weak_junctions(am: AlleleMatrix, phase: np.ndarray,
                          block_id: np.ndarray, min_e: float,
                          adaptive: bool = False, protect=None):
    """Split phase-set blocks at boundaries whose converged junction
    evidence cannot pin the relative orientation of the two sides — an
    undetectable switch error there would flip every downstream call in
    the block.  WhatsHap makes the same precision/contiguity trade by
    ending blocks at weak junctions.

    Two criteria: `min_e` > 0 is the absolute-threshold rule (junction
    evidence below min(min_e, block median/20)) and takes precedence as the
    explicit override; `adaptive` is the coverage-relative rule above,
    which needs no scale constant and does not backfire at low coverage
    (docs/PC_SCALE.md).  Returns (block_id, block_ps); block_ps None means
    nothing split."""
    if min_e > 0:
        adaptive = False
    elif not adaptive:
        return block_id, None
    ev = _junction_evidence(am, phase, block_id)
    new_block = np.zeros(am.n_sites, dtype=bool)
    for b, (cols_b, E, M, N) in ev.items():
        if len(E) == 0:
            continue
        med_E = float(np.median(E))
        if adaptive:
            weak_mask = E < med_E / ADAPTIVE_REL
            guard = E < ADAPTIVE_RHO * M
            if ADAPTIVE_N1:
                guard |= N <= 1
            weak = np.flatnonzero(weak_mask & guard)
        else:
            # junction evidence scales with coverage, so the cutoff is
            # relative to the block's own median (an outlier ~50x weaker
            # than its peers), capped by min_e so well-supported blocks
            # never split
            weak = np.flatnonzero(E < min(min_e, med_E / 20.0))
        if protect is not None and len(weak):
            p_lo = am.site_pos[cols_b[weak]]
            p_hi = am.site_pos[cols_b[weak + 1]]
            weak = weak[~_junction_protected(protect, p_lo, p_hi)]
        new_block[cols_b[weak + 1]] = True
    if not new_block.any():
        return block_id, None
    # re-number over COVERED sites only: interior uncovered (-1) sites are
    # normal inside a block (a read may skip a site) and must not introduce
    # spurious block starts on either side
    cov_idx = np.flatnonzero(block_id >= 0)
    prev_blk = block_id[cov_idx]
    starts = np.ones(len(cov_idx), dtype=bool)
    starts[1:] = prev_blk[1:] != prev_blk[:-1]
    starts |= new_block[cov_idx]
    bid_cov = (np.cumsum(starts) - 1).astype(np.int32)
    out_id = np.full(am.n_sites, -1, dtype=np.int32)
    out_id[cov_idx] = bid_cov
    nblocks = int(bid_cov[-1]) + 1 if len(bid_cov) else 0
    block_ps = np.zeros(nblocks, dtype=np.int64)
    blocks, first = np.unique(bid_cov, return_index=True)
    block_ps[blocks] = am.site_pos[cov_idx[first]] + 1
    return out_id, block_ps


def _power_refine(am: AlleleMatrix, phase: np.ndarray, block_id: np.ndarray,
                  sweeps: int = 2):
    """Alternating majority updates (read haps <-> site phases), restricted so
    sites never change blocks. Equivalent to the device kernel's matmul power
    iteration (duet_tpu.ops.haplotag) on the sparse layout."""
    from duet_tpu_torch.utils import dispatch

    dispatch.record("phase_refine", "host")
    av = am.allele.astype(np.float64) * am.weight
    for _ in range(sweeps):
        s = np.zeros(am.n_reads, dtype=np.float64)
        np.add.at(s, am.row, av * phase[am.col])
        h = np.sign(s)
        v = np.zeros(am.n_sites, dtype=np.float64)
        np.add.at(v, am.col, av * h[am.row])
        new_phase = np.where(v > 0, 1, np.where(v < 0, -1, phase)).astype(np.int8)
        phase = np.where(block_id >= 0, new_phase, 0).astype(np.int8)
    return phase


def _haplotag(am: AlleleMatrix, phase: np.ndarray, block_id: np.ndarray,
              block_ps: np.ndarray):
    """Final read scoring -> (hap, ps, pc) per read."""
    from duet_tpu_torch.utils import dispatch

    dispatch.record("haplotag", "host")
    n = am.n_reads
    av = am.allele.astype(np.float64) * am.weight
    signed = np.zeros(n, dtype=np.float64)
    total = np.zeros(n, dtype=np.float64)
    np.add.at(signed, am.row, av * phase[am.col])
    informative = (phase[am.col] != 0)
    np.add.at(total, am.row, np.abs(av) * informative)

    # per-read dominant block (largest summed weight)
    nblocks = len(block_ps)
    read_hap = np.zeros(n, dtype=np.int8)
    read_ps = np.full(n, -1, dtype=np.int64)
    read_pc = np.full(n, -1, dtype=np.int32)
    if nblocks and len(am.row):
        blk = block_id[am.col].astype(np.int64)
        ok = blk >= 0
        # groupby (read, block) via sort — avoids a dense n x nblocks matrix
        key = am.row[ok].astype(np.int64) * nblocks + blk[ok]
        order = np.argsort(key, kind="stable")
        ks = key[order]
        ws = am.weight[ok][order].astype(np.float64)
        group_start = np.ones(len(ks), dtype=bool)
        group_start[1:] = ks[1:] != ks[:-1]
        gid = np.cumsum(group_start) - 1
        gsum = np.bincount(gid, weights=ws)
        gkey = ks[group_start]
        g_read = (gkey // nblocks).astype(np.int64)
        g_block = (gkey % nblocks).astype(np.int64)
        # per read: block with the largest summed weight
        best_w = np.zeros(n, dtype=np.float64)
        np.maximum.at(best_w, g_read, gsum)
        is_best = gsum == best_w[g_read]
        # earliest best block wins ties: reversed fancy assignment makes the
        # first (block-sorted) best group's write land last
        best_block = np.zeros(n, dtype=np.int64)
        sel = np.flatnonzero(is_best)[::-1]
        best_block[g_read[sel]] = g_block[sel]
        has = np.zeros(n, dtype=bool)
        has[g_read] = True
        tagged = has & (total > 0) & (signed != 0)
        read_hap[tagged] = np.where(signed[tagged] > 0, 1, 2)
        read_ps[tagged] = block_ps[best_block[tagged]]
        margin = np.abs(signed[tagged])
        read_pc[tagged] = np.clip(
            np.rint(PC_PER_MARGIN * margin), 1, PC_MAX
        ).astype(np.int32)
    return read_hap, read_ps, read_pc


HAPLOTAG_BATCH = 16   # 256-row chunks per device call (single fixed shape)

HAPLOTAG_B = 126      # block columns per window: K = 2 + B = one 128-lane tile


def _finish_scored(am: AlleleMatrix, phase: np.ndarray, block_id: np.ndarray,
                   block_ps: np.ndarray, scored):
    """(read_hap, read_ps, read_pc) from a sparse scoring launch's
    (hap, pc, best_block, overflow) — the shared epilogue of the
    single-contig and multi-contig device paths, with the host fallback
    for reads spanning more than SLOT_K phase-set blocks."""
    n = am.n_reads
    read_hap = np.zeros(n, dtype=np.int8)
    read_ps = np.full(n, -1, dtype=np.int64)
    read_pc = np.full(n, -1, dtype=np.int32)
    hap, pc, best, overflow = scored
    tagged = (hap != 0) & ~overflow
    read_hap[tagged] = hap[tagged]
    read_pc[tagged] = pc[tagged]
    read_ps[tagged] = block_ps[best[tagged]]
    wide = np.flatnonzero(overflow)
    if len(wide):
        sub = np.isin(am.row, wide)
        sub_am = AlleleMatrix(n, am.n_sites, am.site_pos, am.row[sub],
                              am.col[sub], am.allele[sub], am.weight[sub])
        h, p, c = _haplotag(sub_am, phase, block_id, block_ps)
        read_hap[wide] = h[wide]
        read_ps[wide] = p[wide]
        read_pc[wide] = c[wide]
    return read_hap, read_ps, read_pc


def _scatter_tagged(read_hap, read_pc, read_ps, block_ps, present, rows,
                    hap, pc, best):
    """Write one chunk's kernel outputs back to the per-read arrays."""
    tagged = hap != 0
    rsel = rows[tagged]
    read_hap[rsel] = hap[tagged]
    read_pc[rsel] = pc[tagged]
    if len(present):
        read_ps[rsel] = block_ps[present[best[tagged]]]


def _as_result(am, phase, block_id, block_ps, tagging) -> PhaseResult:
    """PhaseResult from one contig's core state + a (hap, ps, pc) tagging."""
    read_hap, read_ps, read_pc = tagging
    return PhaseResult(am.site_pos, phase, block_id, block_ps,
                       read_hap, read_ps, read_pc, row_names=am.row_names)


@span("snp_phasing.read_haps")
def read_hap_map(cr: ContigReads, result: PhaseResult) -> dict[str, tuple[int, int, int]]:
    """name -> (hap, ps, pc) join map, the decision stage's input (mirrors
    reference read_hap_bam's dict, sv_phasing_fn.py:11-34).  Rows are
    already name-grouped (split alignments pooled), so this is a direct
    per-row emit."""
    names = result.row_names if result.row_names is not None else cr.names
    out = {}
    for i in range(len(names)):
        if result.read_hap[i] != 0:
            out[names[i]] = (
                int(result.read_hap[i]), int(result.read_ps[i]),
                int(result.read_pc[i]),
            )
    return out


@span("write.phased_snp_vcf")
def write_phased_snp_vcf(path: str, contig: str, snps: ContigSnps,
                         result: PhaseResult) -> None:
    """Per-contig phased SNP VCF (artifact parity with the reference's
    snp_phasing/phased_{chr}.vcf.gz contract, snp_phasing.py:23-24)."""
    from duet_tpu_torch.io.vcf import write_vcf
    from duet_tpu_torch.models.snp_caller_host import BASES

    header = [
        "##fileformat=VCFv4.2",
        "##source=duet_tpu.snp_phaser",
        f"##contig=<ID={contig}>",
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=PS,Number=1,Type=Integer,Description="Phase set">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE",
    ]
    het_idx = np.flatnonzero(snps.is_het)
    pos_to_row = {int(snps.pos[k]): k for k in het_idx}
    rows = []  # (pos, record) so the emitted VCF stays position-sorted
    for j in range(len(result.site_pos)):
        p = int(result.site_pos[j])
        k = pos_to_row[p]
        if result.phase[j] == 0:
            gt, ps = "0/1", "."
        else:
            gt = "1|0" if result.phase[j] > 0 else "0|1"
            ps = str(result.block_ps[result.block_id[j]])
        rows.append((p, f"{contig}\t{p + 1}\t.\t{BASES[snps.ref_code[k]]}\t"
                        f"{BASES[snps.alt_code[k]]}\t.\tPASS\t.\tGT:PS\t{gt}:{ps}"))
    # hom-alt sites pass through unphased (WhatsHap phases hets only)
    for k in np.flatnonzero(~snps.is_het):
        rows.append((int(snps.pos[k]),
                     f"{contig}\t{snps.pos[k] + 1}\t.\t{BASES[snps.ref_code[k]]}\t"
                     f"{BASES[snps.alt_code[k]]}\t.\tPASS\t.\tGT:PS\t1/1:."))
    rows.sort(key=lambda r: r[0])
    write_vcf(path, header, [r[1] for r in rows])
