"""SV genotyping and phasing with the decision pass on torch.

Packing, the regime and anchor logic, the float64 host features and the
verbatim T1-T5 tree are the port's copies of ``duet_tpu.models.sv_phaser``'s
(``sv_phaser_host``); the two
functions here are its copies whose device branch runs
``duet_tpu_torch.ops.phase_decide``.
"""

from __future__ import annotations

import numpy as np
import torch

from duet_tpu_torch.io.vcf import SVRecord
from duet_tpu_torch.models.sv_phaser_host import (
    HP_STRINGS,
    attach_read_haplotypes,
    build_oneps_set,
    compute_features,
    decide_haplotype,
    distinct_ps_regime,
    pack_calls,
)
from duet_tpu_torch.ops.phase_decide import MAX_SLOTS_EXACT

_CPU = torch.device("cpu")


def phase_chromosome(
    records: list[SVRecord],
    read_hap: dict[str, tuple[int, int, int]],
    svlen_min: int,
    support_min: int,
    use_device: bool = False,
    phase_bnd: bool = False,
    decision_model: str = "verbatim",
    device: torch.device = _CPU,
) -> list[dict]:
    """Mirrors ``duet_tpu.models.sv_phaser.phase_chromosome``: phased-call
    dicts of one chromosome (unsorted).  use_device runs the feature and
    decision pass on `device`, bit-identical to the float64 host path."""
    from duet_tpu_torch.utils import dispatch

    attach_read_haplotypes(records, read_hap)
    kept = [
        r for r in records
        if (abs(r.svlen) >= svlen_min or (phase_bnd and r.svtype == "BND"))
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

    if decision_model == "learned":
        from duet_tpu_torch.models.decision_model import decide_haplotype_learned

        dispatch.record("sv_decide", "host")
        feats = compute_features(packed, regime, oneps)
        pred = decide_haplotype_learned(feats, regime)
        feats_ps = feats.ps
    elif use_device and packed.tagged.shape[1] <= MAX_SLOTS_EXACT:
        from duet_tpu_torch.ops.phase_decide import phase_decide_packed

        dispatch.record("sv_decide", "device")
        pred, ps_arr = phase_decide_packed(packed, oneps, device)
        feats_ps = ps_arr.astype(np.int64)
    else:
        dispatch.record("sv_decide", "host")
        feats = compute_features(packed, regime, oneps)
        pred = decide_haplotype(feats, regime)
        feats_ps = feats.ps

    out = []
    # reference emission order within a chromosome: regime 0, then 1, then 2
    for want in (0, 1, 2):
        for i in np.flatnonzero((regime == want) & (pred > 0)):
            rec = packed.records[i]
            out.append({
                "ps": int(feats_ps[i]),
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


def phase_callset(
    per_chrom_records: dict[str, list[SVRecord]],
    read_hap_by_chrom: dict[str, dict[str, tuple[int, int, int]]],
    svlen_min: int,
    support_min: int,
    use_device: bool = False,
    phase_bnd: bool = False,
    decision_model: str = "verbatim",
    device: torch.device = _CPU,
) -> list[dict]:
    """Mirrors ``duet_tpu.models.sv_phaser.phase_callset``: every
    chromosome, then the reference's final order (chrom string, pos)."""
    phased: list[dict] = []
    for name, records in per_chrom_records.items():
        phased.extend(
            phase_chromosome(records, read_hap_by_chrom.get(name, {}),
                             svlen_min, support_min, use_device=use_device,
                             phase_bnd=phase_bnd,
                             decision_model=decision_model, device=device))
    phased.sort(key=lambda c: (c["chrom"], c["pos"]))
    return phased
