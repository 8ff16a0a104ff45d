"""The fused SV phase-decision pass in torch, in exact int32.

Port of ``duet_tpu.ops.phase_decide``: one call takes the packed (calls x
support-read slots) arrays and returns the haplotype prediction and phase
set of every call — regime classification, masked tallies, the
best-supported phase set among the anchors, the nearest-anchor fallback
(right element on ties) and the reference's T1-T5 tree
(src/duet/sv_phasing_fn.py:70-183).  Each ratio threshold is restated as an
integer comparison (a/b <= p/q  <=>  a*q <= p*b), exact while the products
fit int32: with pc <= 8100 and S slots the largest is 8100*S*S, so S <=
MAX_SLOTS_EXACT.  Reductions pass ``dtype=torch.int32`` because torch
widens integer sums to int64 by default.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_SLOTS_EXACT = 500  # 8100 * 500 * 500 < 2**31
PC_MAX = 8100
_PC_PAD = np.int32(2**30)
_I32 = torch.int32


def _regime(tagged, ps):
    """0/1/2 distinct phase sets among tagged reads (no pc cut)."""
    p = torch.where(tagged, ps, -1)
    srt = torch.sort(p, dim=1).values
    changes = ((srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] >= 0)).sum(
        dim=1, dtype=_I32)
    # +1 only when slot 0 is already valid (no -1 padding present)
    first = (srt[:, 0] >= 0).to(_I32)
    return torch.clamp(changes + first, max=2)


def _nearest(oneps, pos):
    """Nearest anchor, right element on exact ties (reference :106-111)."""
    idx = torch.searchsorted(oneps, pos)
    left = torch.clamp(idx - 1, min=0)
    right = torch.clamp(idx, max=len(oneps) - 1)
    take_left = (pos - oneps[left]).abs() < (pos - oneps[right]).abs()
    return torch.where(take_left, oneps[left], oneps[right])


def phase_decide(pos, svread, refread, n_slots, hap, ps, pc, tagged, oneps):
    """Returns (pred int32 in {0,1,2,3}, ps int32) per call.

    Integer inputs are int32, `tagged` bool; `oneps` is the sorted,
    non-empty anchor array of the chromosome."""
    n, S = tagged.shape
    regime = _regime(tagged, ps)
    q = tagged & (pc <= PC_MAX)

    def tally(mask):
        return mask.sum(dim=1, dtype=_I32), \
            torch.where(mask, pc, 0).sum(dim=1, dtype=_I32)

    # regime-1 tallies
    m1 = q & (hap == 1)
    m2 = q & (hap == 2)
    h1_r1, sc1_r1 = tally(m1)
    h2_r1, sc2_r1 = tally(m2)
    any_q = q.any(dim=1)
    # last qualifying slot: argmax over the reversed mask (first max wins)
    last_q = S - 1 - torch.argmax(torch.flip(q, [1]).to(_I32), dim=1)
    ps_r1 = torch.where(any_q, torch.gather(ps, 1, last_q[:, None])[:, 0], 0)

    # regime-2 tallies: best-supported phase set among the anchors
    loc = torch.searchsorted(oneps, ps.reshape(-1)).reshape(n, S)
    in_ops = q & (oneps[torch.clamp(loc, max=len(oneps) - 1)] == ps)
    same = in_ops[:, :, None] & in_ops[:, None, :] \
        & (ps[:, :, None] == ps[:, None, :])
    tot = same.sum(dim=2, dtype=_I32)
    tot_masked = torch.where(in_ops, tot, -1)
    best = torch.argmax(tot_masked, dim=1)  # earliest slot of max-count PS
    has_ops = in_ops.any(dim=1)
    ps_best = torch.gather(ps, 1, best[:, None])[:, 0]
    sel = in_ops & (ps == ps_best[:, None])
    s1 = sel & (hap == 1)
    s2 = sel & (hap == 2)
    h1_s, sc1_s = tally(s1)
    h2_s, sc2_s = tally(s2)
    h1_r2 = torch.where(has_ops, h1_s, 0)
    h2_r2 = torch.where(has_ops, h2_s, 0)
    sc1_r2 = torch.where(has_ops, sc1_s, 0)
    sc2_r2 = torch.where(has_ops, sc2_s, 0)
    allhap_r2 = q.sum(dim=1, dtype=_I32)
    hap0 = torch.where(has_ops, allhap_r2 - h1_r2 - h2_r2, 0)

    is1 = regime == 1
    is2 = regime == 2

    def pick(r1, r2):
        return torch.where(is1, r1, torch.where(is2, r2, 0))

    h1 = pick(h1_r1, h1_r2)
    h2 = pick(h2_r1, h2_r2)
    sc1 = pick(sc1_r1, sc1_r2)
    sc2 = pick(sc2_r1, sc2_r2)
    allhap = pick(h1_r1 + h2_r1, allhap_r2)
    ps_out = pick(ps_r1, torch.where(has_ops, ps_best, 0))

    fallback = (regime == 0) | ((h1 == 0) & (h2 == 0))
    ps_out = torch.where(fallback, _nearest(oneps, pos), ps_out)

    # ---- decision tree, exact integer comparisons ----------------------
    a = svread
    T = svread + refread
    m1c = torch.clamp(h1, min=1)
    m2c = torch.clamp(h2, min=1)
    P = m1c * m2c
    avg_diff_num = (sc2 * m1c - sc1 * m2c).abs()  # |avg2-avg1| * P

    pred = torch.zeros(n, dtype=_I32, device=pos.device)

    # regime 0: sv_ratio == 1 and sv_num >= 4
    pred = torch.where((regime == 0) & (refread == 0) & (a >= 4), 3, pred)

    # regime 2: sv_ratio >= 0.72; avg diff <= 1369.50 ? sv_num>=3 : hap0>=6
    le_13695 = avg_diff_num <= 1369 * P + P // 2
    r2_hit = (25 * a >= 18 * T) & torch.where(le_13695, a >= 3, hap0 >= 6)
    pred = torch.where(is2 & r2_hit, 3, pred)

    # regime 1
    onehap = (sc1 > 0) ^ (sc2 > 0)
    gate = ((4 * allhap <= 3 * n_slots) & (avg_diff_num <= 2400 * P)) \
        | (4 * allhap > 3 * n_slots)
    side_avg = torch.where(sc1 > 0, 1, 2)
    side_tot = torch.where(sc1 > sc2, 1, 2)
    b_mid = (25 * a > 6 * T) & (10 * a <= 9 * T) & gate
    b_hi = (10 * a > 9 * T) & gate
    p_one = torch.where(b_mid, side_avg, torch.where(b_hi, 3, 0))

    lo = torch.minimum(sc1, sc2)
    hi = torch.maximum(sc1, sc2)
    ratio_le_972 = torch.where(lo > 0, 25 * hi <= 243 * lo, True)  # 0 <= 9.72
    band2 = (10 * a > 3 * T) & (20 * a <= 9 * T)
    band3 = (20 * a > 9 * T) & (4 * a <= 3 * T)
    band4 = 4 * a > 3 * T
    p_both = torch.where(band2, torch.where(refread > 10, 0, side_tot), 0)
    p_both = torch.where(band3, torch.where(ratio_le_972, 3, side_tot), p_both)
    p_both = torch.where(band4, 3, p_both)

    pred = torch.where(is1, torch.where(onehap, p_one, p_both), pred)
    return pred.to(_I32), ps_out.to(_I32)


def _pow2(x: int, floor: int = 8) -> int:
    return max(floor, 1 << (max(x, 1) - 1).bit_length())


def phase_decide_packed(packed, oneps_sorted: np.ndarray,
                        device: torch.device = torch.device("cpu")):
    """PackedCalls + anchors -> numpy (pred, ps), run on `device`.

    Shapes are padded to powers of two as in the JAX package (calls,
    support slots, anchors): padded calls carry no support and are dropped,
    padded slots are untagged, padded anchors repeat the last value."""
    from duet_tpu_torch.utils import devcost

    if packed.tagged.shape[1] > MAX_SLOTS_EXACT:
        raise ValueError(
            f"support-read slots {packed.tagged.shape[1]} > "
            f"{MAX_SLOTS_EXACT}: int32 exactness bound exceeded; use the "
            "host path")
    n, S = packed.tagged.shape
    n_pad = _pow2(n)
    s_pad = max(min(_pow2(S), MAX_SLOTS_EXACT), S)
    a_pad = _pow2(len(oneps_sorted), floor=4)

    def pad1(x, fill, dtype=np.int32):
        return np.pad(np.asarray(x, dtype), (0, n_pad - n),
                      constant_values=fill)

    def pad2(x, fill, dtype=np.int32):
        return np.pad(np.asarray(x, dtype), ((0, n_pad - n), (0, s_pad - S)),
                      constant_values=fill)

    oneps = np.asarray(oneps_sorted, np.int32)
    oneps = np.pad(oneps, (0, a_pad - len(oneps)), mode="edge")
    dev = devcost.put(
        "sv_decide", device,
        pad1(packed.pos, 0), pad1(packed.svread, 0),
        pad1(packed.refread, 1), pad1(packed.n_slots, 1),
        pad2(packed.hap, 0), pad2(packed.ps, -1),
        pad2(np.minimum(packed.pc, _PC_PAD), _PC_PAD),
        pad2(packed.tagged, False, dtype=bool), oneps)
    pred, ps = devcost.run("sv_decide", device, lambda: phase_decide(*dev))
    return (devcost.get("sv_decide", pred)[:n],
            devcost.get("sv_decide", ps)[:n])
