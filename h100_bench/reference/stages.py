"""The host route of the four pipeline stages, as plain numpy.

Frozen copies of the host branches of ``duet_tpu_torch``'s stage glue:
``ops/cluster.py::cluster_host_multi`` (the clustering), the host lines of
``models/sv_caller.py`` (``call_svs_for_contig``,
``call_contig_with_evidence``), ``models/snp_phaser.py``
(``phase_contig_core``, and ``_haplotag`` for the scoring),
``models/sv_phaser.py`` (``phase_chromosome`` under the verbatim decision
tree, ``phase_callset``) and ``models/nn_snp.py::nn_call_snps`` with the
numpy forward pass.  Device, mesh and dispatch lines are taken out; the
arithmetic is the host route's.

``Precision`` carries the two places where the program computes in float32
on the card: the neural caller's matrix products and the sums of the
phasing's refine sweeps and read scoring.  ``FLOAT32`` is the stated
precision; ``control.CONTROL`` computes the same in the precision below it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from h100_bench.reference.fasta import decode_bases
from h100_bench.reference.nn_snp_host import (
    candidate_sites,
    extract_features,
    load_params,
)
from h100_bench.reference.snp_caller_host import (
    ContigSnps,
    SnpCallConfig,
    call_snps,
    choose_snp_model,
)
from h100_bench.reference.snp_phaser_host import (
    REFINE_CORRECT_ROUNDS,
    _as_result,
    _haplotag,
    _initial_phase,
    _power_refine,
    _split_weak_junctions,
    _switch_correct,
    build_allele_matrix,
    scatter_sum,
)
from h100_bench.reference.sv_caller_host import (
    SVTYPE_INS,
    TYPE_NAMES,
    Signatures,
    SvCall,
    SvCallConfig,
    _genotype,
    _spanning_dr,
    bnd_evidence_for_contig,
    cmd_as_rational,
    contig_tables,
    extract_signatures,
    extract_split_signatures,
)
from h100_bench.reference.sv_phaser_host import (
    HP_STRINGS,
    attach_read_haplotypes,
    build_oneps_set,
    compute_features,
    decide_haplotype,
    distinct_ps_regime,
    pack_calls,
)

GAP = 0
SPAN = 1


def matmul_f32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """A float32 matrix product (the card's, with TF32 off)."""
    return a.astype(np.float32) @ b.astype(np.float32)


@dataclass(frozen=True)
class Precision:
    """How the reference computes what the program computes in float32 on
    the card: `matmul` for the neural caller's products, `scatter_sum` for
    the phasing's sums."""

    name: str
    matmul: object = matmul_f32
    scatter_sum: object = scatter_sum


FLOAT32 = Precision("float32")


# -- SNP calling ------------------------------------------------------------

@dataclass
class NnCandidates:
    """The neural caller's candidates of one contig and its logits for
    each: what the comparison reads a served class's gap from."""

    pos: np.ndarray
    ref_code: np.ndarray
    alt_code: np.ndarray
    alt_count: np.ndarray
    depth: np.ndarray
    logits: np.ndarray   # (n, 3) float32: non-variant, het, hom-alt


def nn_logits(feats: np.ndarray, prec: Precision) -> np.ndarray:
    """The MLP's logits (``nn_snp_host.apply_np``) with `prec`'s products."""
    p = load_params()
    h = np.maximum(prec.matmul(feats, p["W1"]) + p["b1"], 0.0)
    h = np.maximum(prec.matmul(h, p["W2"]) + p["b2"], 0.0)
    return (prec.matmul(h, p["W3"]) + p["b3"]).astype(np.float32)


def nn_call_snps(contig: str, counts: np.ndarray, ref_codes: np.ndarray,
                 prec: Precision) -> tuple[ContigSnps, NnCandidates]:
    """ContigSnps via the network, and its candidates with their logits."""
    pos, alt_code, alt_count, depth = candidate_sites(counts, ref_codes)
    feats = extract_features(counts, ref_codes, pos, alt_code)
    logits = nn_logits(feats, prec) if len(pos) else \
        np.zeros((0, 3), np.float32)
    cls = logits.argmax(axis=1)
    keep = cls >= 1
    snps = ContigSnps(
        contig=contig,
        pos=pos[keep],
        ref_code=ref_codes[pos[keep]].astype(np.uint8),
        alt_code=alt_code[keep],
        is_het=cls[keep] == 1,
        depth=depth[keep].astype(np.int32),
        alt_count=alt_count[keep].astype(np.int32),
    )
    return snps, NnCandidates(pos, ref_codes[pos].astype(np.uint8), alt_code,
                              alt_count, depth, logits)


def call_snps_any(contig: str, counts: np.ndarray, ref_codes: np.ndarray,
                  cfg: SnpCallConfig, prec: Precision):
    """(ContigSnps, NnCandidates or None): the counting rule, the neural
    caller, or the auto policy's pick between them."""
    model = cfg.model
    if model == "auto":
        model = choose_snp_model(counts, ref_codes)
    if model == "nn":
        return nn_call_snps(contig, counts, ref_codes, prec)
    return call_snps(contig, counts, ref_codes, cfg), None


# -- SV calling -------------------------------------------------------------

def cluster_host_multi(svtype, pos, length, read_idx, linkage: int,
                       md_by_type, cmd_num: int, cmd_den: int):
    """One clustering pass over all SV types: signatures sort by (type,
    position), a type change forces a segment break, and the gap threshold
    is looked up per type.  Returns (call_pos, call_len, support, count,
    seg_of_input, call_type)."""
    k = len(pos)
    if k == 0:
        e = np.zeros(0, dtype=np.int64)
        return e, e, e, e, e, e
    order = np.lexsort((pos, svtype))
    t = np.asarray(svtype)[order]
    p, l, r = pos[order], length[order], read_idx[order]
    md = np.asarray(md_by_type, dtype=np.int64)[t]
    if linkage == SPAN:
        dpos = np.abs(p[1:] - p[:-1])
        dlen = np.abs(l[1:] - l[:-1])
        denom = np.maximum(np.maximum(l[1:], l[:-1]), 1)
        brk = (dpos + dlen).astype(np.float32) * np.float32(cmd_den) \
            > denom.astype(np.float32) * np.float32(cmd_num)
    else:
        brk = (p[1:] - p[:-1]) > md[1:]
    brk = brk | (t[1:] != t[:-1])
    seg = np.zeros(k, dtype=np.int64)
    seg[1:] = np.cumsum(brk)
    nseg = int(seg[-1]) + 1

    count = np.bincount(seg, minlength=nseg)
    start = np.zeros(nseg, dtype=np.int64)
    start[1:] = np.cumsum(count)[:-1]
    med = start + (count - 1) // 2
    call_pos = p[med]
    call_type = t[med].astype(np.int64)

    lorder = np.lexsort((l, seg))
    call_len = l[lorder][med]

    rorder = np.lexsort((r, seg))
    rs, rr = seg[rorder], r[rorder]
    first = np.ones(k, dtype=bool)
    first[1:] = (rs[1:] != rs[:-1]) | (rr[1:] != rr[:-1])
    support = np.bincount(rs, weights=first, minlength=nseg).astype(np.int64)

    seg_of_input = np.empty(k, dtype=np.int64)
    seg_of_input[order] = seg
    return call_pos, call_len, support, count.astype(np.int64), \
        seg_of_input, call_type


def _all_clusters(sigs: Signatures, cfg: SvCallConfig):
    """(svtype, call_pos, call_len, member_rows) for every cluster of every
    SV type, all types in one pass."""
    k = len(sigs.pos)
    if k == 0:
        return
    num, den = cmd_as_rational(cfg.cluster_max_distance)
    md_by_type = (cfg.max_dist_ins, cfg.max_dist_del,
                  cfg.max_dist_del, cfg.max_dist_del)
    call_pos, call_len, support, count, seg_of_input, call_type = \
        cluster_host_multi(sigs.svtype.astype(np.int32), sigs.pos,
                           sigs.length, sigs.read_idx,
                           SPAN if cfg.linkage == "span" else GAP,
                           md_by_type, num, den)
    order = np.argsort(seg_of_input, kind="stable")
    bounds = np.zeros(len(call_pos) + 1, dtype=np.int64)
    np.cumsum(count, out=bounds[1:])
    seg_order = np.lexsort((call_pos, call_type))
    for s in seg_order:
        yield (int(call_type[s]), int(call_pos[s]), int(call_len[s]),
               order[bounds[s]:bounds[s + 1]])


def call_svs_for_contig(cr, cfg: SvCallConfig, tables) -> list[SvCall]:
    """One contig's intra-contig SV calls."""
    cig = extract_signatures(cr, cfg)
    spl = extract_split_signatures(cr, cfg, tables)
    sigs = Signatures(
        np.concatenate([cig.svtype, spl.svtype]),
        np.concatenate([cig.pos, spl.pos]),
        np.concatenate([cig.length, spl.length]),
        np.concatenate([cig.read_idx, spl.read_idx]),
        np.concatenate([
            cig.qpos if cig.qpos is not None
            else np.full(len(cig.pos), -1, dtype=np.int64),
            np.full(len(spl.pos), -1, dtype=np.int64),
        ]),
    )
    calls: list[SvCall] = []
    buf = cfg.span_buffer
    for svtype, cp, cl, member_sigs in _all_clusters(sigs, cfg):
        if cl < cfg.min_size:
            continue
        member_reads = sigs.read_idx[member_sigs]
        uniq_rows = np.unique(member_reads)
        names = sorted({cr.names[i] for i in uniq_rows})
        support = len(names)
        if support < cfg.min_support:
            continue
        dr = _spanning_dr(tables.pool_starts, tables.pool_ends_sorted,
                          tables.prim_span, names, cp, buf)
        dv = support
        af = dv / max(dv + dr, 1)
        alt_seq = None
        if svtype == SVTYPE_INS:
            for j in member_sigs:
                q = sigs.qpos_or_none(j)
                if sigs.length[j] != cl or q < 0:
                    continue
                rd = int(sigs.read_idx[j])
                s0 = int(cr.seq_off[rd]) + q
                if s0 + cl <= int(cr.seq_off[rd + 1]):
                    alt_seq = decode_bases(cr.seq[s0:s0 + cl])
                    break
        calls.append(SvCall(
            contig=cr.contig, pos=cp, svtype=TYPE_NAMES[svtype], length=cl,
            support=support, read_names=names,
            gt=_genotype(af, dv + dr, cfg), dr=dr, dv=dv, alt_seq=alt_seq,
        ))
    calls.sort(key=lambda c: c.pos)
    return calls


def call_contig_with_evidence(cr, cfg: SvCallConfig):
    """(intra-contig calls, breakend evidence) sharing one table scan."""
    tables = contig_tables(cr, cfg)
    return (call_svs_for_contig(cr, cfg, tables),
            bnd_evidence_for_contig(cr, cfg, tables))


# -- SNP phasing ------------------------------------------------------------

def phase_contig(cr, snps, cfg: SnpCallConfig, obs, prec: Precision,
                 min_junction_evidence: float = 0.0,
                 adaptive_junction_split: bool = True,
                 protect_intervals=None, sweeps: int = 2):
    """One contig's refine/correct loop, weak-junction split and read
    scoring -> PhaseResult."""
    am = build_allele_matrix(cr, snps, cfg, obs=obs)
    phase, block_id, block_ps = _initial_phase(am)

    def refine(phase):
        return _power_refine(am, phase, block_id, sweeps,
                             acc=prec.scatter_sum)

    phase = refine(phase)
    for _ in range(REFINE_CORRECT_ROUNDS):
        corrected = _switch_correct(am, phase, block_id)
        changed = bool(np.any(corrected != phase))
        phase = refine(corrected)
        if not changed:
            break
    new_id, new_ps = _split_weak_junctions(
        am, phase, block_id, min_junction_evidence,
        adaptive=adaptive_junction_split, protect=protect_intervals)
    if new_ps is not None:
        block_id, block_ps = new_id, new_ps
    tagging = _haplotag(am, phase, block_id, block_ps, acc=prec.scatter_sum)
    return _as_result(am, phase, block_id, block_ps, tagging)


# -- SV phasing -------------------------------------------------------------

def phase_chromosome(records, read_hap, svlen_min: int,
                     support_min: int) -> list[dict]:
    """Phased-call dicts of one chromosome (unsorted), by the verbatim
    decision tree in float64."""
    attach_read_haplotypes(records, read_hap)
    kept = [
        r for r in records
        if abs(r.svlen) >= svlen_min
        and r.support >= support_min and r.gt != "./."
    ]
    if not kept:
        return []
    packed = pack_calls(kept)
    regime = distinct_ps_regime(packed)
    oneps = build_oneps_set(packed, np.ones(packed.n, dtype=bool), regime)
    if len(oneps) == 0:
        # the reference skips the whole chromosome when no anchor exists
        return []
    feats = compute_features(packed, regime, oneps)
    pred = decide_haplotype(feats, regime)
    out = []
    # emission order within a chromosome: regime 0, then 1, then 2
    for want in (0, 1, 2):
        for i in np.flatnonzero((regime == want) & (pred > 0)):
            rec = packed.records[i]
            out.append({
                "ps": int(feats.ps[i]),
                "hp": HP_STRINGS[int(pred[i])],
                "chrom": rec.chrom,
                "pos": rec.pos,
                "svlen": abs(rec.svlen) if rec.svtype in ("INS", "DUP")
                else -abs(rec.svlen),
                "svtype": rec.svtype,
                "ref": rec.ref,
                "alt": rec.alt,
            })
    return out


def phase_callset(per_chrom_records, read_hap_by_chrom, svlen_min: int,
                  support_min: int) -> list[dict]:
    """Every chromosome, then the final order (chrom string, pos)."""
    phased: list[dict] = []
    for name, records in per_chrom_records.items():
        phased.extend(phase_chromosome(
            records, read_hap_by_chrom.get(name, {}), svlen_min,
            support_min))
    phased.sort(key=lambda c: (c["chrom"], c["pos"]))
    return phased
