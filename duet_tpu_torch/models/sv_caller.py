"""Device glue of the SV-calling stage: clustering on torch.

Signature extraction, the per-contig tables, genotyping, breakend calling
and the VCF writer are the port's copies of ``duet_tpu.models.sv_caller``'s
(``sv_caller_host``); the functions here are copies of its stage functions
whose clustering goes through ``duet_tpu_torch.ops.cluster``, or under a
device mesh through ``duet_tpu_torch.parallel.shard_cluster``.
"""

from __future__ import annotations

import numpy as np
import torch

from duet_tpu_torch.io.readstore import ContigReads
from duet_tpu_torch.models.sv_caller_host import (
    SVTYPE_DEL,
    SVTYPE_DUP,
    SVTYPE_INS,
    SVTYPE_INV,
    TYPE_NAMES,
    ContigTables,
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

_CPU = torch.device("cpu")


def _cluster_one_type(pos, length, read_idx, cfg: SvCallConfig, svtype: int,
                      mesh):
    """Mirrors ``duet_tpu.models.sv_caller._cluster_one_type``: mesh-sharded
    single-type clustering (coordinate halos over the sp axis,
    ``parallel.shard_cluster``) -> list of (call_pos, call_len,
    member_rows), member_rows indexing the input signature arrays."""
    from duet_tpu_torch.ops.cluster import GAP, SPAN
    from duet_tpu_torch.parallel.shard_cluster import cluster_sharded

    k = len(pos)
    if k == 0:
        return []
    num, den = cmd_as_rational(cfg.cluster_max_distance)
    max_dist = cfg.max_dist_ins if svtype == SVTYPE_INS else cfg.max_dist_del
    linkage = SPAN if cfg.linkage == "span" else GAP
    call_pos, call_len, support, count, seg_of_input = cluster_sharded(
        mesh, pos, length, read_idx, linkage, max_dist, num, den)
    order = np.argsort(seg_of_input, kind="stable")
    bounds = np.zeros(len(call_pos) + 1, dtype=np.int64)
    np.cumsum(count, out=bounds[1:])
    out = []
    for s in range(len(call_pos)):
        rows = order[bounds[s]:bounds[s + 1]]
        out.append((int(call_pos[s]), int(call_len[s]), rows))
    return out


def _all_clusters(sigs: Signatures, cfg: SvCallConfig,
                  device: torch.device = _CPU, mesh=None):
    """Mirrors ``duet_tpu.models.sv_caller._all_clusters``: yield (svtype,
    call_pos, call_len, member_rows) for every cluster of every SV type.
    Without a mesh all types cluster in ONE pass (sorted by type, then
    position; a type change breaks), on `device` when cfg.device and the
    signature count clears cfg.device_min_k.  With `mesh` each type is
    clustered on the mesh, whatever cfg.device says (the mesh is an
    explicit opt-in)."""
    from duet_tpu_torch.ops.cluster import GAP, SPAN, cluster_multi

    if mesh is not None:
        from duet_tpu_torch.utils import dispatch

        for svtype in (SVTYPE_INS, SVTYPE_DEL, SVTYPE_INV, SVTYPE_DUP):
            m = sigs.svtype == svtype
            sig_idx = np.flatnonzero(m)
            if m.any():
                dispatch.record("sv_cluster", "mesh")
            for cp, cl, rows_f in _cluster_one_type(
                    sigs.pos[m], sigs.length[m], sigs.read_idx[m], cfg,
                    svtype, mesh=mesh):
                yield svtype, cp, cl, sig_idx[rows_f]
        return
    k = len(sigs.pos)
    if k == 0:
        return
    num, den = cmd_as_rational(cfg.cluster_max_distance)
    md_by_type = (cfg.max_dist_ins, cfg.max_dist_del,
                  cfg.max_dist_del, cfg.max_dist_del)
    call_pos, call_len, support, count, seg_of_input, call_type = \
        cluster_multi(sigs.svtype.astype(np.int32), sigs.pos, sigs.length,
                      sigs.read_idx,
                      SPAN if cfg.linkage == "span" else GAP, md_by_type,
                      num, den,
                      device=cfg.device and k >= cfg.device_min_k,
                      torch_device=device)
    order = np.argsort(seg_of_input, kind="stable")
    bounds = np.zeros(len(call_pos) + 1, dtype=np.int64)
    np.cumsum(count, out=bounds[1:])
    # emission in per-type order (INS, DEL, INV, DUP), positions ascending
    seg_order = np.lexsort((call_pos, call_type))
    for s in seg_order:
        yield (int(call_type[s]), int(call_pos[s]), int(call_len[s]),
               order[bounds[s]:bounds[s + 1]])


def call_svs_for_contig(cr: ContigReads, cfg: SvCallConfig,
                        tables: ContigTables | None = None,
                        device: torch.device = _CPU,
                        mesh=None) -> list[SvCall]:
    """Mirrors ``duet_tpu.models.sv_caller.call_svs_for_contig``."""
    tables = tables or contig_tables(cr, cfg)
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
    for svtype, cp, cl, member_sigs in _all_clusters(sigs, cfg, device,
                                                      mesh):
        if cl < cfg.min_size:
            continue
        member_reads = sigs.read_idx[member_sigs]
        uniq_rows = np.unique(member_reads)
        names = sorted({cr.names[i] for i in uniq_rows})
        support = len(names)
        if support < cfg.min_support:
            continue
        # DR: distinct read names whose PRIMARY alignment spans the locus
        # and that do not support the event
        dr = _spanning_dr(tables.pool_starts, tables.pool_ends_sorted,
                          tables.prim_span, names, cp, buf)
        dv = support
        af = dv / max(dv + dr, 1)
        # the inserted sequence of the member whose length IS the call's
        # lower-median length
        alt_seq = None
        if svtype == SVTYPE_INS:
            from duet_tpu_torch.io.fasta import decode_bases

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


def call_contig_with_evidence(cr: ContigReads, cfg: SvCallConfig,
                              device: torch.device = _CPU, mesh=None):
    """Mirrors ``duet_tpu.models.sv_caller.call_contig_with_evidence``:
    (intra-contig calls, breakend evidence) sharing one table scan."""
    tables = contig_tables(cr, cfg)
    return (call_svs_for_contig(cr, cfg, tables, device=device, mesh=mesh),
            bnd_evidence_for_contig(cr, cfg, tables))
