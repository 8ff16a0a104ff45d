"""Device glue of the SNP-calling stage, on torch.

Port of the device branches of ``duet_tpu.models.snp_caller``.  The op
table (``match_op_table``), the host recount ``_host_window``, the
counting rule and the VCF writers are the port's copies in
``snp_caller_host``; the functions here are copies of its dispatch
functions with the device lines changed to the torch kernel
(``ops.pileup``) and the neural caller to the torch module
(``models.nn_snp``).  Two changes keep the device route's host side below
the host route's: the read bases are packed into the kernel's payload on
the device (``_payload_on_device``, the bytes of ``_pack_codes`` and
``_nibble_pack``), and the at-site pass of several contigs runs on the
thread pool, overlapping the launches (``_device_store``).  `device` is
the torch device a device route runs on.
"""

from __future__ import annotations

import numpy as np
import torch

from duet_tpu_torch.io.readstore import ReadStore
from duet_tpu_torch.models.snp_caller_host import (
    DEVICE_MAX_SITE_DENSITY,
    DEVICE_PILEUP_WINDOW,
    ContigSnps,
    SnpCallConfig,
    _as_rational,
    _assemble_snps,
    _at_site_obs,
    _host_window,
    _pack_codes,
    _pow2,
    call_snps,
    choose_snp_model,
    filter_observations_to_sites,
    match_op_table,
    pileup_with_counts,
)
from duet_tpu_torch.utils.spans import span

_CPU = torch.device("cpu")


def call_snps_any(contig: str, counts: np.ndarray, ref_codes: np.ndarray,
                  cfg: SnpCallConfig, nn_device: torch.device = _CPU
                  ) -> ContigSnps:
    """Mirrors ``duet_tpu.models.snp_caller.call_snps_any``: the counting
    rule, the neural caller (torch, on `nn_device`) or the auto policy."""
    from duet_tpu_torch.utils import dispatch
    from duet_tpu_torch.models.nn_snp import nn_call_snps

    model = cfg.model
    if model == "auto":
        with span("snp_calling.model_choice"):
            model = choose_snp_model(counts, ref_codes)
    if model == "nn":
        dispatch.record("snp_pileup", "nn")
        return nn_call_snps(contig, counts, ref_codes, device=nn_device)
    dispatch.record("snp_pileup", "host")
    with span("snp_calling.count_rule"):
        return call_snps(contig, counts, ref_codes, cfg)


def _host_codes(reads, cfg: SnpCallConfig) -> np.ndarray:
    """The 4-bit codes (``_pack_codes``) of `reads`, concatenated on the
    host: the input of the host recounts."""
    return np.concatenate([_pack_codes(seq, qual, cfg.min_base_qual)
                           for seq, qual in reads])


def _payload_on_device(reads, ref_window: np.ndarray, ns_pad: int, Lw: int,
                       min_base_qual: int,
                       device: torch.device) -> torch.Tensor:
    """``payload_ref`` built on `device` from the reads' bases and
    qualities: each base's 4-bit code (``_pack_codes``), two a byte, even
    base index in the low nibble (``_nibble_pack``), zeros up to ns_pad / 2,
    then the reference window padded with 4.  The same bytes the host
    packers give, without their passes over every base on the host."""
    from duet_tpu_torch.utils import devcost

    codes = []
    for seq, qual in reads:
        seq_d, qual_d = devcost.put("snp_pileup", device, seq, qual)
        if 0 <= min_base_qual <= 255:
            passed = qual_d >= min_base_qual
        else:
            passed = torch.full_like(qual_d, min_base_qual <= 0,
                                     dtype=torch.bool)
        codes.append((passed.to(torch.uint8) << 3) | seq_d)
    (ref_d,) = devcost.put("snp_pileup", device, ref_window)
    code = torch.cat(codes)
    if len(code) % 2:
        code = torch.cat([code, code.new_zeros(1)])
    half = ns_pad // 2
    payload = torch.zeros(half + Lw, dtype=torch.uint8, device=device)
    payload[:len(code) // 2] = code[0::2] | (code[1::2] << 4)
    payload[half:] = 4                    # ref=4 padding never calls
    payload[half:half + len(ref_window)] = ref_d
    return payload


def window_ops(cfg: SnpCallConfig, rw, q0, ln, n_bases: int, rats):
    """A window's op table and sizes: (ops4 (4, K) int32, the padded lane
    count, the padded nibble count).  The ops are padded so their
    cumulative length covers the lanes exactly (a tail op absorbs the pad
    lanes, masked by n_real); row 3 carries the params."""
    af_num, af_den, hom_num, hom_den = rats
    total = int(ln.sum())
    total_pad = _pow2(max(total, 1))
    n_ops = len(ln)
    ops_pad = max(_pow2(n_ops + 1), 1 << 12)
    ops4 = np.zeros((4, ops_pad), np.int32)
    ops4[0, :n_ops] = rw
    ops4[1, :n_ops] = q0
    ops4[2, :n_ops] = ln
    # tail op absorbs the pad lanes (q=0/ref=0; masked via n_real)
    ops4[2, n_ops] = total_pad - total
    ops4[3, :8] = (total, 0, cfg.min_depth,
                   af_num, af_den, hom_num, hom_den, cfg.min_alt_reads)
    return ops4, total_pad, max(_pow2(max(n_bases, 1)), total_pad, 2)


def _device_window(contig: str, ref_window: np.ndarray, cfg: SnpCallConfig,
                   rw, q0, ln, reads, Lw: int, max_sites: int, rats,
                   device: torch.device):
    """Mirrors ``duet_tpu.models.snp_caller._device_window``: ONE padded
    kernel launch for a window (possibly a group of concatenated contigs);
    window-relative parts (pos, alt_code, is_het, depth, alt_count).
    `reads` lists the window's (seq, qual) base arrays in query order; the
    payload is packed from them on the device (``_payload_on_device``).
    The JAX package's host recounts stay: at the 2^30-byte payload bound
    and on compaction overflow."""
    from duet_tpu_torch.ops.pileup import pileup_call_packed
    from duet_tpu_torch.utils import devcost, dispatch

    n_bases = sum(len(seq) for seq, _ in reads)
    if n_bases >= 1 << 30:
        # int32 bound: query offsets and the observation total index this
        # payload; past 2^30 bytes the padded offsets could cross 2^31
        return _host_window(contig, ref_window, cfg, rw, q0, ln,
                            _host_codes(reads, cfg))
    ops4, total_pad, ns_pad = window_ops(cfg, rw, q0, ln, n_bases, rats)
    dispatch.record("snp_pileup", "device")
    (d_ops4,) = devcost.put("snp_pileup", device, ops4)
    out_dev = devcost.run(
        "snp_pileup", device, lambda: pileup_call_packed(
            d_ops4, _payload_on_device(reads, ref_window, ns_pad, Lw,
                                       cfg.min_base_qual, device),
            total=total_pad, length=Lw, max_sites=max_sites))
    out = devcost.get("snp_pileup", out_dev)
    m = int(out[0])
    if m > max_sites:
        # the fixed compaction overflowed: recount this window on the host
        return _host_window(contig, ref_window, cfg, rw, q0, ln,
                            _host_codes(reads, cfg))
    site_idx, alt_code, is_het, depth, alt_count = out[1:].reshape(
        5, max_sites)
    return (site_idx[:m].astype(np.int64),
            alt_code[:m].astype(np.uint8),
            is_het[:m].astype(bool),
            depth[:m].astype(np.int32),
            alt_count[:m].astype(np.int32))


def call_snps_device(contig: str, cr, ref_codes: np.ndarray,
                     cfg: SnpCallConfig, window: int = DEVICE_PILEUP_WINDOW,
                     device: torch.device = _CPU) -> ContigSnps:
    """Mirrors ``duet_tpu.models.snp_caller.call_snps_device``: counting
    and site calling on the device from packed reads, one launch per
    coordinate window."""
    L = len(ref_codes)
    op_ref, op_q, op_len, _ = match_op_table(cr, cfg.min_mapq)
    if len(op_len) and int((op_ref + op_len).max()) > L:
        raise ValueError(
            f"pileup observation at position {int((op_ref + op_len).max()) - 1}"
            f" beyond contig length {L}: read alignment extends past the "
            "contig end"
        )
    Lw = min(_pow2(max(L, 1)), window)
    max_sites = _pow2(max(Lw // DEVICE_MAX_SITE_DENSITY, 256))
    rats = (*_as_rational(cfg.min_af), *_as_rational(cfg.hom_af))
    parts = []
    for lo in range(0, max(L, 1), Lw):
        hi = min(lo + Lw, L)
        if L > Lw:
            sel = (op_ref < hi) & (op_ref + op_len > lo)
            r0, q0, ln = op_ref[sel], op_q[sel], op_len[sel]
            clip = np.maximum(lo - r0, 0)
            s = r0 + clip
            q0 = q0 + clip
            ln = np.minimum(r0 + ln, hi) - s
            if len(q0):
                b0 = int(q0.min())
                b1 = int((q0 + ln).max())
            else:
                b0 = b1 = 0
            reads = [(cr.seq[b0:b1], cr.qual[b0:b1])]
            q0 = q0 - b0
            rw = s - lo
        else:
            rw, q0, ln = op_ref, op_q, op_len
            reads = [(cr.seq, cr.qual)]
        part = _device_window(contig, ref_codes[lo:hi], cfg, rw, q0, ln,
                              reads, Lw, max_sites, rats, device)
        parts.append((part[0] + lo, *part[1:]))
    return _assemble_snps(contig, parts, ref_codes)


def call_snps_device_grouped(items, cfg: SnpCallConfig,
                             window: int = DEVICE_PILEUP_WINDOW,
                             device: torch.device = _CPU
                             ) -> dict[str, ContigSnps]:
    """Mirrors ``duet_tpu.models.snp_caller.call_snps_device_grouped``:
    small contigs are concatenated along the reference axis into shared
    launches; contigs longer than half a window keep their own."""
    return dict(_grouped_launches(items, cfg, window, device))


def _grouped_launches(items, cfg: SnpCallConfig, window: int,
                      device: torch.device):
    """``call_snps_device_grouped``'s launches in order, yielding each
    contig's (name, ContigSnps) as soon as its launch returns."""
    group: list[tuple] = []
    group_L = 0
    group_bytes = 0
    rats = (*_as_rational(cfg.min_af), *_as_rational(cfg.hom_af))

    def flush():
        if len(group) == 1:
            c, cr, ref = group[0]
            return [(c, call_snps_device(c, cr, ref, cfg, window, device))]
        return _launch_group(group, cfg, rats, device)

    for c, cr, ref in items:
        L = len(ref)
        if L > window // 2 or len(cr.seq) >= 1 << 29:
            yield c, call_snps_device(c, cr, ref, cfg, window, device)
            continue
        if group and (_pow2(group_L + L) > window
                      or group_bytes + len(cr.seq) >= 1 << 29):
            yield from flush()
            group.clear()
            group_L = 0
            group_bytes = 0
        group.append((c, cr, ref))
        group_L += L
        group_bytes += len(cr.seq)
    if group:
        yield from flush()


def _launch_group(group, cfg: SnpCallConfig, rats,
                  device: torch.device) -> list[tuple[str, ContigSnps]]:
    """Mirrors ``duet_tpu.models.snp_caller._launch_group``: ONE launch
    for several concatenated contigs, sites split back per contig."""
    ref_all, rw, q0, ln, reads, offs = group_tables(group, cfg)
    ref_off = len(ref_all)
    Lw = _pow2(max(ref_off, 1))
    max_sites = _pow2(max(Lw // DEVICE_MAX_SITE_DENSITY, 256))
    part = _device_window("+".join(c for c, _, _ in group), ref_all, cfg,
                          rw, q0, ln, reads, Lw, max_sites, rats, device)
    pos = part[0]
    bounds = np.searchsorted(pos, offs + [ref_off])
    out = []
    for k, (c, cr, ref) in enumerate(group):
        sl = slice(int(bounds[k]), int(bounds[k + 1]))
        out.append((c, _assemble_snps(
            c, [(pos[sl] - offs[k], part[1][sl], part[2][sl],
                 part[3][sl], part[4][sl])], ref)))
    return out


def group_tables(group, cfg: SnpCallConfig):
    """A group's contigs concatenated along the reference: (reference
    codes, op ref starts, op nibble starts, op lengths, the reads' (seq,
    qual) arrays, each contig's reference offset); a read past its
    contig's end raises."""
    rw_all, q0_all, ln_all, reads, ref_all, offs = [], [], [], [], [], []
    ref_off = 0
    ns_off = 0
    for c, cr, ref in group:
        L = len(ref)
        op_ref, op_q, op_len, _ = match_op_table(cr, cfg.min_mapq)
        if len(op_len) and int((op_ref + op_len).max()) > L:
            raise ValueError(
                f"pileup observation at position "
                f"{int((op_ref + op_len).max()) - 1} beyond contig length "
                f"{L}: read alignment extends past the contig end")
        rw_all.append(op_ref + ref_off)
        q0_all.append(op_q + ns_off)
        ln_all.append(op_len)
        reads.append((cr.seq, cr.qual))
        ref_all.append(ref)
        offs.append(ref_off)
        ref_off += L
        ns_off += len(cr.seq)
    return (np.concatenate(ref_all), np.concatenate(rw_all),
            np.concatenate(q0_all), np.concatenate(ln_all), reads, offs)


def call_contig_snps(contig: str, cr, ref_codes: np.ndarray,
                     cfg: SnpCallConfig, device: torch.device = _CPU,
                     nn_device: torch.device = _CPU):
    """Mirrors ``duet_tpu.models.snp_caller.call_contig_snps``: (ContigSnps,
    at-site observation stream) for one contig.  The forced device path
    (cfg.device) implements the counting rule ('auto' resolves to it);
    otherwise the native counting pass, or the python counting when the
    native library is unavailable (a host-to-host fallback)."""
    from duet_tpu_torch.io.native_ingest import (
        NativeUnavailable,
        pileup_counts_native,
        pileup_obs_native,
    )

    if cfg.device and cfg.model in ("counts", "auto"):
        snps = call_snps_device(contig, cr, ref_codes, cfg, device=device)
        with span("snp_calling.at_site"):
            return snps, _at_site_obs(cr, cfg, snps.pos)
    obs = None
    with span("snp_calling.counts"):
        try:
            counts = pileup_counts_native(cr, cfg.min_mapq,
                                          cfg.min_base_qual, len(ref_codes))
        except (NativeUnavailable, OSError):
            counts = None
        if counts is None:
            obs, counts = pileup_with_counts(cr, cfg, len(ref_codes))
    snps = call_snps_any(contig, counts, ref_codes, cfg, nn_device)
    with span("snp_calling.at_site"):
        if obs is None:
            site_obs, _ = pileup_obs_native(cr, cfg.min_mapq,
                                            site_pos=snps.pos)
            return snps, site_obs
        return snps, filter_observations_to_sites(*obs, snps.pos)


def mesh_pileup_ok(cfg: SnpCallConfig) -> bool:
    """Mirrors ``duet_tpu.models.snp_caller.mesh_pileup_ok``: the
    coordinate-sharded pileup implements the counting rule ('auto'
    resolves to it on a mesh); the nn stays on its own route.  One
    predicate for the batch and streaming call sites."""
    return cfg.model in ("counts", "auto")


def call_snps_for_store(store: ReadStore, ref_codes: dict[str, np.ndarray],
                        cfg: SnpCallConfig | None = None, threads: int = 1,
                        device: torch.device = _CPU,
                        nn_device: torch.device = _CPU, mesh=None):
    """Mirrors ``duet_tpu.models.snp_caller.call_snps_for_store``:
    (snps_by_contig, site_obs_by_contig).  With `mesh`, each contig's
    coordinate axis shards over the mesh's sp axis
    (``parallel.shard_pileup``), whatever cfg.device says."""
    cfg = cfg or SnpCallConfig()
    work = [(c, cr) for c, cr in store.contigs.items() if c in ref_codes]
    if mesh is not None and mesh_pileup_ok(cfg):
        from duet_tpu_torch.parallel.shard_pileup import call_snps_sharded

        snps_out = {c: call_snps_sharded(mesh, c, cr, ref_codes[c], cfg)
                    for c, cr in work}
        obs_out = {c: _at_site_obs(cr, cfg, snps_out[c].pos)
                   for c, cr in work}
        return snps_out, obs_out
    if cfg.device and cfg.model in ("counts", "auto") and len(work) > 1:
        return _device_store(work, ref_codes, cfg, threads, device)

    def one(item):
        contig, cr = item
        snps, site_obs = call_contig_snps(contig, cr, ref_codes[contig], cfg,
                                          device, nn_device)
        return contig, snps, site_obs

    if threads > 1 and len(work) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(threads) as ex:
            results = list(ex.map(one, work))
    else:
        results = list(map(one, work))
    snps_out = {c: s for c, s, _ in results}
    obs_out = {c: o for c, _, o in results}
    return snps_out, obs_out


def _device_store(work, ref_codes: dict[str, np.ndarray], cfg: SnpCallConfig,
                  threads: int, device: torch.device):
    """The grouped device pileup of several contigs, each contig's at-site
    pass (``_at_site_obs``, native) started on a pool of `threads` as soon
    as its launch returns, so it overlaps the launches after it, as the
    host route's pool runs it."""
    from concurrent.futures import ThreadPoolExecutor

    crs = dict(work)
    snps_out: dict[str, ContigSnps] = {}
    pending = {}
    with ThreadPoolExecutor(max(threads, 1)) as ex:
        for c, snps in _grouped_launches(
                [(c, cr, ref_codes[c]) for c, cr in work], cfg,
                DEVICE_PILEUP_WINDOW, device):
            snps_out[c] = snps
            pending[c] = ex.submit(_at_site_obs, crs[c], cfg, snps.pos)
        obs_out = {c: pending[c].result() for c, _ in work}
    return snps_out, obs_out
