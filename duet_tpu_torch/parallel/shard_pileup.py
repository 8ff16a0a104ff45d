"""Coordinate-sharded SNP pileup over a device mesh.

The port of ``duet_tpu.parallel.shard_pileup``.  Pileup counting is
POSITIONAL — observations in disjoint coordinate ranges cannot interact —
so a contig's coordinate axis shards over the mesh's "sp" axis: each shard
owns one contiguous reference window, match ops whose span crosses a window
boundary are CLIPPED to each side (the single-device caller's windowing,
``models.snp_caller.call_snps_device``), site calling is local, and the
only "collective" is stacking each shard's O(max_sites) compacted site list
(JAX's gather of the sharded output).

Each shard runs ``ops.pileup.packed_window_body`` — the single-device
kernel's body, on a card the hand kernels of ``csrc/pileup.cu`` — on its
own device, so the sharded output is bit-identical by construction.  The host-side clipping and packing are the JAX package's
numpy, over the port's copies of its packers (``models.snp_caller_host``).
"""

from __future__ import annotations

import numpy as np


def call_snps_sharded(mesh, contig: str, cr, ref_codes: np.ndarray, cfg):
    """Mesh-sharded twin of ``models.snp_caller.call_snps_device``: returns
    the same ContigSnps, computed with each mesh device owning one
    coordinate window.  Falls back to the bit-identical host caller for an
    empty contig, for per-shard windows above DEVICE_PILEUP_WINDOW and for
    payloads at the int32 exactness bound — the JAX package's guards — and
    recounts any compaction-overflow window on the host; each fallback is
    recorded as a host dispatch."""
    from duet_tpu_torch.models.snp_caller_host import (
        DEVICE_MAX_SITE_DENSITY,
        DEVICE_PILEUP_WINDOW,
        _as_rational,
        _assemble_snps,
        _host_window,
        _nibble_pack,
        _pack_codes,
        _pow2,
        call_snps,
        count_alleles,
        match_op_table,
        pileup_observations,
    )
    from duet_tpu_torch.ops.pileup import packed_window_body
    from duet_tpu_torch.utils import devcost, dispatch

    def host_fallback():
        dispatch.record("snp_pileup", "host")
        obs = pileup_observations(cr, cfg)
        counts = count_alleles(obs[0], obs[1], obs[2], L, cfg.min_base_qual)
        return call_snps(contig, counts, ref_codes, cfg)

    L = len(ref_codes)
    if L == 0:
        return host_fallback()

    op_ref, op_q, op_len, _ = match_op_table(cr, cfg.min_mapq)
    if len(op_len) and int((op_ref + op_len).max()) > L:
        raise ValueError(
            f"pileup observation at position "
            f"{int((op_ref + op_len).max()) - 1} beyond contig length {L}: "
            "read alignment extends past the contig end")

    n_shards = int(mesh.shape["sp"])
    devices = mesh.row(0)
    Lw = _pow2(-(-L // n_shards))
    if Lw > DEVICE_PILEUP_WINDOW:
        # per-shard window above the single-device cap: the (Lw, 4) count
        # image alone would be multi-GB per device
        return host_fallback()
    max_sites = _pow2(max(Lw // DEVICE_MAX_SITE_DENSITY, 256))
    rats = (*_as_rational(cfg.min_af), *_as_rational(cfg.hom_af))
    af_num, af_den, hom_num, hom_den = rats

    # per-shard clipped op tables (the single-device >window path's math)
    shards = []
    for s in range(n_shards):
        lo = s * Lw
        hi = min(lo + Lw, L)
        if lo >= L:
            shards.append((np.zeros(0, op_ref.dtype), np.zeros(0, op_q.dtype),
                           np.zeros(0, op_len.dtype),
                           np.zeros(0, np.uint8), lo, hi))
            continue
        sel = (op_ref < hi) & (op_ref + op_len > lo)
        r0, q0, ln = op_ref[sel], op_q[sel], op_len[sel]
        clip = np.maximum(lo - r0, 0)
        st = r0 + clip
        q0 = q0 + clip
        ln = np.minimum(r0 + ln, hi) - st
        if len(q0):
            b0 = int(q0.min())
            b1 = int((q0 + ln).max())
        else:
            b0 = b1 = 0
        packed = _pack_codes(cr.seq[b0:b1], cr.qual[b0:b1],
                             cfg.min_base_qual)
        shards.append((st - lo, q0 - b0, ln, packed, lo, hi))

    if max(len(s[3]) for s in shards) >= 1 << 30:
        # int32 exactness bound (mirrors _device_window): query offsets,
        # the observation total and the kernel's int32 length cumsum all
        # index the payload; past 2^30 bytes the pow2 pads could cross 2^31
        return host_fallback()
    totals = [int(ln.sum()) for _, _, ln, _, _, _ in shards]
    total_pad = _pow2(max(max(totals), 1))
    ops_pad = max(_pow2(max(len(s[2]) for s in shards) + 1), 1 << 12)
    # ns_pad counts BASES (nibbles); the payload rows carry ns_pad // 2
    # packed bytes + the shard's reference window
    ns_pad = max(_pow2(max(max(len(s[3]) for s in shards), 1)), total_pad,
                 2)

    ops4_all = np.zeros((n_shards, 4, ops_pad), np.int32)
    payload_all = np.zeros((n_shards, ns_pad // 2 + Lw), np.uint8)
    payload_all[:, ns_pad // 2:] = 4         # ref=4 padding never calls
    for s, (rw, q0, ln, packed, lo, hi) in enumerate(shards):
        n_ops = len(ln)
        ops4_all[s, 0, :n_ops] = rw
        ops4_all[s, 1, :n_ops] = q0
        ops4_all[s, 2, :n_ops] = ln
        # tail op absorbs the pad lanes (masked via n_real; gathers stay
        # inside payload because ns_pad >= total_pad)
        ops4_all[s, 2, n_ops] = total_pad - totals[s]
        ops4_all[s, 3, :8] = (totals[s], 0, cfg.min_depth,
                              af_num, af_den, hom_num, hom_den,
                              cfg.min_alt_reads)
        _nibble_pack(packed, payload_all[s])
        payload_all[s, ns_pad // 2: ns_pad // 2 + (hi - lo)] = \
            ref_codes[lo:hi]

    dispatch.record("snp_pileup", "mesh")
    rows = []
    for s, dev in enumerate(devices):
        d_ops, d_pay = devcost.put("snp_pileup", dev, ops4_all[s],
                                   payload_all[s])
        out_s = devcost.run(
            "snp_pileup", dev, lambda: packed_window_body(
                d_ops, d_pay, total=total_pad, length=Lw,
                max_sites=max_sites))
        rows.append(devcost.get("snp_pileup", out_s))
    out = np.stack(rows)

    parts = []
    for s, (rw, q0, ln, packed, lo, hi) in enumerate(shards):
        m = int(out[s, 0])
        if m > max_sites:
            # pathological site density in this window: bit-identical host
            # recount from the clipped tables (single-device caller parity)
            part = _host_window(contig, ref_codes[lo:hi], cfg, rw, q0, ln,
                                packed)
        else:
            site_idx, alt_code, is_het, depth, alt_count = \
                out[s, 1:].reshape(5, max_sites)
            part = (site_idx[:m].astype(np.int64),
                    alt_code[:m].astype(np.uint8),
                    is_het[:m].astype(bool),
                    depth[:m].astype(np.int32),
                    alt_count[:m].astype(np.int32))
        parts.append((part[0] + lo, *part[1:]))
    return _assemble_snps(contig, parts, ref_codes)
