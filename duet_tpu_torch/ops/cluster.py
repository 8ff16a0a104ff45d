"""SV-signature clustering as sorted break flags + segment reductions.

The port of ``duet_tpu.ops.cluster``'s multi-type path: signatures sorted by
(type, position) are cut into clusters where a linkage test fails or the
type changes, and every per-cluster statistic (member count, distinct
supporting reads, lower-median position and length) is a segment reduction
over the segment ids, a cumsum of the break flags.

  linkage GAP  : break when pos[i] - pos[i-1] > max_dist(type)      (cuteSV)
  linkage SPAN : break when (|dpos| + |dlen|) / max(len) > c        (SVIM -c)

The SPAN compare runs in float32 with the same IEEE operations as the numpy
host path and the JAX kernel, so every path agrees bit for bit.
``jnp.lexsort`` becomes two stable sorts.  ``cluster_host``,
``cluster_host_multi`` and ``pad_signatures`` are copies of the numpy
functions of duet_tpu's module, which cannot be imported without jax.
``cluster_device`` is the one-type kernel, which the JAX package uses in
its tests only; the pipeline runs ``cluster_device_multi``.
"""

from __future__ import annotations

import numpy as np
import torch

GAP = 0
SPAN = 1
_POS_PAD = np.int32(2**31 - 1)
_I32 = torch.int32


def cluster_host(pos, length, read_idx, linkage: int, max_dist: int,
                 cmd_num: int, cmd_den: int):
    """Copy of ``duet_tpu.ops.cluster.cluster_host`` (numpy): one SV type's
    clustering of position-sorted signatures.  Returns (call_pos,
    call_len, support, count, seg_id_per_signature)."""
    k = len(pos)
    if k == 0:
        e = np.zeros(0, dtype=np.int64)
        return e, e, e, e, e
    order = np.argsort(pos, kind="stable")
    p, l, r = pos[order], length[order], read_idx[order]
    if linkage == SPAN:
        dpos = np.abs(p[1:] - p[:-1])
        dlen = np.abs(l[1:] - l[:-1])
        denom = np.maximum(np.maximum(l[1:], l[:-1]), 1)
        brk = (dpos + dlen).astype(np.float32) * np.float32(cmd_den) \
            > denom.astype(np.float32) * np.float32(cmd_num)
    else:
        brk = (p[1:] - p[:-1]) > max_dist
    seg = np.zeros(k, dtype=np.int64)
    seg[1:] = np.cumsum(brk)
    nseg = int(seg[-1]) + 1

    count = np.bincount(seg, minlength=nseg)
    start = np.zeros(nseg, dtype=np.int64)
    start[1:] = np.cumsum(count)[:-1]
    med = start + (count - 1) // 2
    call_pos = p[med]

    lorder = np.lexsort((l, seg))
    l_sorted = l[lorder]
    call_len = l_sorted[med]

    rorder = np.lexsort((r, seg))
    rs, rr = seg[rorder], r[rorder]
    first = np.ones(k, dtype=bool)
    first[1:] = (rs[1:] != rs[:-1]) | (rr[1:] != rr[:-1])
    support = np.bincount(rs, weights=first, minlength=nseg).astype(np.int64)

    seg_of_input = np.empty(k, dtype=np.int64)
    seg_of_input[order] = seg
    return call_pos, call_len, support, count.astype(np.int64), seg_of_input


def cluster_host_multi(svtype, pos, length, read_idx, linkage: int,
                       md_by_type, cmd_num: int, cmd_den: int):
    """Copy of ``duet_tpu.ops.cluster.cluster_host_multi`` (numpy).

    One clustering pass over ALL SV types: signatures sort by (type,
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


def pad_signatures(pos, length, read_idx, pad_to: int):
    """Copy of ``duet_tpu.ops.cluster.pad_signatures``: pad to a fixed
    size with +inf-position sentinels (trailing padding segments)."""
    k = len(pos)
    if k > pad_to:
        raise ValueError(f"{k} signatures > pad_to={pad_to}")
    pp = np.full(pad_to, _POS_PAD, dtype=np.int32)
    ll = np.zeros(pad_to, dtype=np.int32)
    rr = np.full(pad_to, -1, dtype=np.int32)
    pp[:k] = pos
    ll[:k] = length
    rr[:k] = read_idx
    return pp, ll, rr, k


def _break_flags(p_prev, l_prev, v_prev, p_next, l_next, v_next,
                 linkage: int, max_dist, cmd_num: int, cmd_den: int):
    """Linkage test between consecutive sorted signatures (int32 inputs)."""
    dpos = p_next - p_prev
    if linkage == SPAN:
        dlen = (l_next - l_prev).abs()
        denom = torch.clamp(torch.maximum(l_next, l_prev), min=1)
        num = torch.tensor(cmd_num, dtype=torch.float32, device=dpos.device)
        den = torch.tensor(cmd_den, dtype=torch.float32, device=dpos.device)
        brk = (dpos.abs() + dlen).to(torch.float32) * den \
            > denom.to(torch.float32) * num
    else:
        brk = dpos > max_dist
    # padding slots break away from real segments
    return brk | (v_next != v_prev)


def _lexsort2(minor, major):
    """Indices sorting by (major, minor), ties in index order — the
    order of ``jnp.lexsort((minor, major))``."""
    o1 = torch.sort(minor, stable=True).indices
    o2 = torch.sort(major[o1], stable=True).indices
    return o1[o2]


def _segment_stats(p, l, r, v, seg):
    """Per-cluster statistics from sorted signatures and their
    non-decreasing segment ids; one entry per segment slot (slots past the
    last real segment have count 0)."""
    k = p.shape[0]
    bounds = torch.searchsorted(seg, torch.arange(k + 1, dtype=_I32,
                                                  device=seg.device))
    zero = torch.zeros(1, dtype=_I32, device=seg.device)
    # padded slots carry v = 0: count real members only
    ones_cs = torch.cat([zero, torch.cumsum(v.to(_I32), 0, dtype=_I32)])
    count = ones_cs[bounds[1:]] - ones_cs[bounds[:-1]]
    start = bounds[:-1]
    med = torch.clamp(start + torch.div(count - 1, 2, rounding_mode="floor"),
                      0, k - 1)
    call_pos = p[med]

    call_len = l[_lexsort2(l, seg)][med]

    rorder = _lexsort2(r, seg)
    rs = seg[rorder]          # == seg: the primary key is already sorted
    rr = r[rorder]
    rv = v[rorder]
    firsts = torch.ones(k, dtype=torch.bool, device=seg.device)
    firsts[1:] = (rs[1:] != rs[:-1]) | (rr[1:] != rr[:-1])
    sup_cs = torch.cat([zero, torch.cumsum((firsts & rv).to(_I32), 0,
                                           dtype=_I32)])
    support = sup_cs[bounds[1:]] - sup_cs[bounds[:-1]]
    return {
        "call_pos": call_pos,
        "call_len": call_len,
        "support": support,
        "count": count,
        "is_seg": count > 0,
        "seg_of_sorted": seg,
    }


def cluster_device_multi(svtype, pos, length, read_idx, valid,
                         linkage: int, md_by_type, cmd_num: int,
                         cmd_den: int) -> dict[str, torch.Tensor]:
    """Multi-type clustering over arrays PRE-SORTED by (type, position)
    with padding at the tail (the wrapper sorts on the host)."""
    k = pos.shape[0]
    t = svtype
    md = md_by_type[torch.clamp(t, 0, md_by_type.shape[0] - 1).long()]
    brk = _break_flags(pos[:-1], length[:-1], valid[:-1],
                       pos[1:], length[1:], valid[1:],
                       linkage, md[1:], cmd_num, cmd_den)
    brk = brk | (t[1:] != t[:-1])
    zero = torch.zeros(1, dtype=_I32, device=pos.device)
    seg = torch.cat([zero, torch.cumsum(brk.to(_I32), 0, dtype=_I32)])
    out = _segment_stats(pos, length, read_idx, valid, seg)
    count = out["count"]
    start = torch.cat([zero, torch.cumsum(count, 0, dtype=_I32)[:-1]])
    med = torch.clamp(start + torch.div(count - 1, 2, rounding_mode="floor"),
                      0, k - 1)
    out["call_type"] = t[med]
    return out


def cluster_multi(svtype, pos, length, read_idx, linkage: int, md_by_type,
                  cmd_num: int, cmd_den: int, device: bool = False,
                  pad_to: int | None = None,
                  torch_device: torch.device = torch.device("cpu")):
    """Host/device dispatch for the one-pass multi-type clustering, with
    the return contract of ``cluster_host_multi``.  `device` picks the
    torch route, run on `torch_device`; shapes are padded to a power of two
    with a 2048 floor, as in the JAX package."""
    from duet_tpu_torch.utils import devcost, dispatch

    k = len(pos)
    if k == 0:
        e = np.zeros(0, dtype=np.int64)
        return e, e, e, e, e, e
    if not device:
        dispatch.record("sv_cluster", "host")
        return cluster_host_multi(svtype, pos, length, read_idx, linkage,
                                  md_by_type, cmd_num, cmd_den)
    dispatch.record("sv_cluster", "device")
    if pad_to is None:
        pad_to = max(1 << (k - 1).bit_length(), 2048)
    order = np.lexsort((pos, svtype))
    pp, ll, rr, _ = pad_signatures(np.asarray(pos, np.int32)[order],
                                   np.asarray(length, np.int32)[order],
                                   np.asarray(read_idx, np.int32)[order],
                                   pad_to)
    tt = np.full(pad_to, 127, dtype=np.int32)
    tt[:k] = np.asarray(svtype)[order]
    vv = np.zeros(pad_to, dtype=bool)
    vv[:k] = True
    dev = devcost.put("sv_cluster", torch_device, tt, pp, ll, rr, vv,
                      np.asarray(md_by_type, np.int32))
    out = devcost.run(
        "sv_cluster", torch_device, lambda: cluster_device_multi(
            dev[0], dev[1], dev[2], dev[3], dev[4], linkage, dev[5],
            cmd_num, cmd_den))

    def get(key):
        return devcost.get("sv_cluster", out[key])

    sel = np.flatnonzero(get("is_seg"))
    seg_of_input = np.empty(k, dtype=np.int64)
    seg_of_input[order] = get("seg_of_sorted")[:k]
    return (get("call_pos")[sel], get("call_len")[sel], get("support")[sel],
            get("count")[sel], seg_of_input, get("call_type")[sel])


def cluster_device(pos, length, read_idx, n_valid: int, linkage: int,
                   max_dist, cmd_num: int, cmd_den: int
                   ) -> dict[str, torch.Tensor]:
    """One SV type's clustering over padded signature tensors; the port of
    ``duet_tpu.ops.cluster.cluster_device``.  Sorts the first `n_valid`
    slots by position on the device (padding after them), then cuts and
    reduces segments.  Returns the per-slot statistics of
    ``_segment_stats`` plus the sort ``order``."""
    k = pos.shape[0]
    valid = torch.arange(k, device=pos.device) < n_valid
    key = torch.where(valid, pos, int(_POS_PAD))
    order = torch.sort(key, stable=True).indices
    p, l, r, v = pos[order], length[order], read_idx[order], valid[order]
    brk = _break_flags(p[:-1], l[:-1], v[:-1], p[1:], l[1:], v[1:],
                       linkage, max_dist, cmd_num, cmd_den)
    zero = torch.zeros(1, dtype=_I32, device=pos.device)
    seg = torch.cat([zero, torch.cumsum(brk.to(_I32), 0, dtype=_I32)])
    out = _segment_stats(p, l, r, v, seg)
    out["order"] = order
    return out


def cluster_device_to_host(pos, length, read_idx, linkage: int,
                           max_dist: int, cmd_num: int, cmd_den: int,
                           torch_device: torch.device = torch.device("cpu")):
    """Pad, run ``cluster_device`` on `torch_device`, unpad: the return
    contract of ``cluster_host``; the port of
    ``duet_tpu.ops.cluster.cluster_device_to_host``."""
    k = len(pos)
    if k == 0:
        e = np.zeros(0, dtype=np.int64)
        return e, e, e, e, e
    pad_to = max(1 << (k - 1).bit_length(), 8)
    pp, ll, rr, n = pad_signatures(np.asarray(pos, np.int32),
                                   np.asarray(length, np.int32),
                                   np.asarray(read_idx, np.int32), pad_to)
    out = cluster_device(*(torch.from_numpy(x).to(torch_device)
                           for x in (pp, ll, rr)),
                         n, linkage, max_dist, cmd_num, cmd_den)
    out = {name: t.cpu().numpy() for name, t in out.items()}
    sel = np.flatnonzero(out["is_seg"])
    seg_of_input = np.empty(k, dtype=np.int64)
    seg_of_input[out["order"][:k]] = out["seg_of_sorted"][:k]
    return (out["call_pos"][sel], out["call_len"][sel], out["support"][sel],
            out["count"][sel], seg_of_input)
