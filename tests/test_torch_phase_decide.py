"""The SV decision pass of the torch port against the JAX kernel, the
float64 host path and the independent oracle (tests/reference_oracle.py).
Exact equality: the port computes in int32 like the JAX kernel."""

import numpy as np
import pytest
import torch

from duet_tpu.io.vcf import SVRecord
from duet_tpu.models import sv_phaser as svp
from duet_tpu.ops.phase_decide import phase_decide_packed as jax_decide
from duet_tpu_torch.utils import dispatch
from duet_tpu_torch.models import sv_phaser as tsvp
from duet_tpu_torch.ops.phase_decide import phase_decide_packed
from reference_oracle import oracle_phase_chromosome
from test_sv_phaser import random_callset

CPU = torch.device("cpu")


def packed_case(seed):
    rng = np.random.default_rng(1000 + seed)
    calls, records, read_hap = random_callset(rng, n_calls=60)
    svp.attach_read_haplotypes(records, read_hap)
    kept = [r for r in records
            if abs(r.svlen) >= 50 and r.support >= 2 and r.gt != "./."]
    packed = svp.pack_calls(kept)
    regime = svp.distinct_ps_regime(packed)
    oneps = svp.build_oneps_set(packed, np.ones(packed.n, bool), regime)
    return packed, regime, oneps


@pytest.mark.parametrize("seed", range(6))
def test_decide_matches_jax_and_host(seed):
    packed, regime, oneps = packed_case(seed)
    assert len(oneps)
    pred_j, ps_j = jax_decide(packed, oneps)
    pred, ps = phase_decide_packed(packed, oneps, CPU)
    assert pred.dtype == np.int32 and ps.dtype == np.int32
    np.testing.assert_array_equal(pred, np.asarray(pred_j))
    np.testing.assert_array_equal(ps, np.asarray(ps_j))
    feats = svp.compute_features(packed, regime, oneps)
    np.testing.assert_array_equal(pred, svp.decide_haplotype(feats, regime))
    np.testing.assert_array_equal(ps, feats.ps)


@pytest.mark.parametrize("seed", range(6))
def test_phase_chromosome_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    calls, records, read_hap = random_callset(rng, n_calls=40)
    dispatch.reset()
    got = tsvp.phase_chromosome(records, read_hap, svlen_min=50,
                                support_min=2, use_device=True, device=CPU)
    want = oracle_phase_chromosome(calls, svlen_min=50, support_min=2)
    assert got == want
    if got:
        assert dispatch.snapshot()["sv_decide"] == {"device": 1}


def test_threshold_edges_exact():
    """Decision-tree boundaries (1369.50, 2400, 9.72, 0.72) hit exactly,
    with one-unit perturbations on each side."""
    def mk(svread, refread, reads, n_names=None):
        names = [f"r{i}" for i in range(n_names or len(reads))]
        rec = SVRecord(chrom="chr1", pos=1000, call_id="x", ref="N",
                       alt="<DEL>", qual=".", filt="PASS", info="", fmt="",
                       sample="", svlen=-100, svtype="DEL", support=svread,
                       read_names=names, gt="0/1", ref_reads=refread)
        rec.read_haps = reads + [None] * (len(names) - len(reads))
        return rec

    two_ps = [(1, 100, 50), (2, 100, 50), (1, 200, 50), (2, 200, 50)]
    cases = [
        (mk(18, 7, two_ps), [100, 200], 3),
        (mk(179, 71, two_ps), [100, 200], 0),
        (mk(18, 7, [(1, 100, 1000), (2, 100, 2369), (2, 100, 2370),
                    (1, 200, 50)]), [100, 200], 3),
        (mk(18, 7, [(1, 100, 1000), (2, 100, 2370), (2, 100, 2371),
                    (1, 200, 50)]), [100, 200], 0),
        (mk(5, 5, [(1, 100, 2400)], n_names=4), [100], 1),
        (mk(5, 5, [(1, 100, 2401)], n_names=4), [100], 0),
        (mk(6, 4, [(1, 100, 972), (2, 100, 100)]), [100], 3),
        (mk(6, 4, [(1, 100, 973), (2, 100, 100)]), [100], 1),
    ]
    for rec, oneps, want in cases:
        packed = svp.pack_calls([rec])
        oneps = np.array(oneps, dtype=np.int64)
        pred, ps = phase_decide_packed(packed, oneps, CPU)
        pred_j, ps_j = jax_decide(packed, oneps)
        assert pred[0] == int(np.asarray(pred_j)[0]) == want, rec.read_haps
        assert ps[0] == int(np.asarray(ps_j)[0])


def test_slot_bound_raises():
    rec = SVRecord(chrom="chr1", pos=1000, call_id="x", ref="N", alt="<DEL>",
                   qual=".", filt="PASS", info="", fmt="", sample="",
                   svlen=-100, svtype="DEL", support=3,
                   read_names=[f"r{i}" for i in range(501)], gt="0/1",
                   ref_reads=1)
    rec.read_haps = [(1, 100, 10)] * 501
    with pytest.raises(ValueError):
        phase_decide_packed(svp.pack_calls([rec]), np.array([100]), CPU)
