"""Coordinate-sharded SV-signature clustering over a device mesh.

The port of ``duet_tpu.parallel.shard_cluster``.  The position-sorted
signatures of one contig are split into contiguous COORDINATE RANGES along
the mesh's "sp" axis, one range per shard.  Chain linkage only looks at
adjacent signatures, so the one cross-shard dependency is each range's
first element against its left neighbour's last: shard s > 0 receives
shard s-1's last (pos, len, valid) as a halo (JAX's ``ppermute``).  Segment
ids become global through an exclusive scan of the per-shard break totals
(JAX's ``all_gather`` of one scalar a shard), and the per-cluster
statistics run through the single-device kernel's segment-reduction core
(``ops.cluster._segment_stats``) over the shards' arrays concatenated on
the first shard's device, as XLA gathers them — so clusters that straddle
a shard edge reduce exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from duet_tpu_torch.ops.cluster import _POS_PAD, _break_flags, _segment_stats

_I32 = torch.int32


def _global_segment_ids(shards, devices, linkage: int, max_dist,
                        cmd_num: int, cmd_den: int) -> list[torch.Tensor]:
    """Per-shard break flags with a one-element left halo, then globally
    consistent segment ids; shards[s] = (p, l, v) on devices[s]."""
    brks = []
    for s, (p, l, v) in enumerate(shards):
        brk_in = _break_flags(p[:-1], l[:-1], v[:-1], p[1:], l[1:], v[1:],
                              linkage, max_dist, cmd_num, cmd_den)
        if s == 0:
            brk_first = torch.zeros(1, dtype=torch.bool, device=p.device)
        else:
            # halo: the left neighbour's last element (shard s-1 -> s)
            prev_p, prev_l, prev_v = (x[-1:].to(devices[s])
                                      for x in shards[s - 1])
            brk_first = _break_flags(prev_p, prev_l, prev_v, p[:1], l[:1],
                                     v[:1], linkage, max_dist, cmd_num,
                                     cmd_den)
        brks.append(torch.cat([brk_first, brk_in]).to(_I32))
    # exclusive scan of the per-shard break totals -> each shard's offset
    totals = [b.sum(dtype=_I32) for b in brks]
    segs = []
    for s, b in enumerate(brks):
        offset = torch.zeros((), dtype=_I32, device=devices[s])
        for t in totals[:s]:
            offset = offset + t.to(devices[s])
        segs.append(offset + torch.cumsum(b, 0, dtype=_I32))
    return segs


def cluster_sharded(mesh, pos, length, read_idx, linkage: int, max_dist: int,
                    cmd_num: int, cmd_den: int):
    """Mesh-sharded clustering; same contract as ``ops.cluster.cluster_host``:
    returns (call_pos, call_len, support, count, seg_of_input).

    Signatures are sorted by position on the host, padded to a
    shard-divisible power of two, and split into one contiguous coordinate
    range per device of the mesh's "sp" axis (its first row)."""
    k = len(pos)
    if k == 0:
        e = np.zeros(0, dtype=np.int64)
        return e, e, e, e, e
    n_shards = int(mesh.shape["sp"])
    devices = mesh.row(0)
    pad_to = max(1 << (k - 1).bit_length(), 8, 2 * n_shards)
    pad_to = -(-pad_to // n_shards) * n_shards
    order = np.argsort(np.asarray(pos), kind="stable")

    pp = np.full(pad_to, _POS_PAD, dtype=np.int32)
    ll = np.zeros(pad_to, dtype=np.int32)
    rr = np.full(pad_to, -1, dtype=np.int32)
    vv = np.zeros(pad_to, dtype=bool)
    pp[:k] = np.asarray(pos, np.int32)[order]
    ll[:k] = np.asarray(length, np.int32)[order]
    rr[:k] = np.asarray(read_idx, np.int32)[order]
    vv[:k] = True

    n = pad_to // n_shards
    shards = [tuple(torch.from_numpy(x[s * n:(s + 1) * n]).to(devices[s])
                    for x in (pp, ll, vv)) for s in range(n_shards)]
    segs = _global_segment_ids(shards, devices, linkage, max_dist, cmd_num,
                               cmd_den)
    first = devices[0]
    seg = torch.cat([x.to(first) for x in segs])
    p, l, v = (torch.cat([sh[i].to(first) for sh in shards])
               for i in range(3))
    out = _segment_stats(p, l, torch.from_numpy(rr).to(first), v, seg)

    is_seg = out["is_seg"].cpu().numpy()
    sel = np.flatnonzero(is_seg)
    seg_of_input = np.empty(k, dtype=np.int64)
    seg_of_input[order] = seg.cpu().numpy()[:k]
    return (
        out["call_pos"].cpu().numpy()[sel],
        out["call_len"].cpu().numpy()[sel],
        out["support"].cpu().numpy()[sel],
        out["count"].cpu().numpy()[sel],
        seg_of_input,
    )
