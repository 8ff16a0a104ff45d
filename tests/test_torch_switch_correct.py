"""The port's switch correction by local updates
(``models.snp_phaser.SwitchCorrector``) against the host copy
``snp_phaser_host._switch_correct``: the same phase, bit for bit, on
seeded allele matrices and on the simulator's reads at the 10x, ~10%-error
deployment's rates; ``phase_contig_core`` unchanged through its rounds;
and a non-integral weight taking the host copy."""

import os

import numpy as np
import pytest

from duet_tpu_torch.io.fasta import FastaFile
from duet_tpu_torch.io.readstore import load_read_store
from duet_tpu_torch.models import snp_phaser as tsp
from duet_tpu_torch.models.snp_caller import call_snps_for_store
from duet_tpu_torch.models.snp_phaser_host import (
    AlleleMatrix,
    _block_obs_groups,
    _boundary_E,
    _initial_phase,
    _switch_correct,
)
from duet_tpu_torch.sim import SimConfig, simulate_dataset
from duet_tpu_torch.utils import spans

# the simulator's parameters of h100_bench/configs/synth-ont-q10-10x.json
# but its length: R9.4.1-era reads at 10x, about 10% read error
Q10 = dict(coverage=10.0, read_len_mean=12_000, read_len_sigma=0.35,
           snp_rate=0.0013, sub_error=0.096, indel_error=0.0173,
           qual_mean=22, hp_indel_rate=0.0207, hp_indel_exponent=1.6,
           read_qual_wander=0.45)


def coo(rows, cols, allele, weight, n_sites) -> AlleleMatrix:
    rows = np.asarray(rows, dtype=np.int32)
    return AlleleMatrix(
        n_reads=int(rows.max()) + 1 if len(rows) else 0, n_sites=n_sites,
        site_pos=np.arange(n_sites, dtype=np.int64) * 100 + 7, row=rows,
        col=np.asarray(cols, dtype=np.int32),
        allele=np.asarray(allele, dtype=np.int8),
        weight=np.asarray(weight, dtype=np.float32))


def random_reads(rng, n_reads, n_sites, span, lo=0, row0=0, dup=False):
    """Reads of up to `span` sites from [lo, lo + n_sites), each site kept
    with probability 0.8, random alleles and integral weights 1-40, in a
    shuffled order; `dup` repeats some (read, site) pairs."""
    rows, cols = [], []
    for r in range(n_reads):
        s = lo + int(rng.integers(0, n_sites))
        c = np.arange(s, min(lo + n_sites, s + int(rng.integers(1, span + 1))))
        c = c[rng.random(len(c)) < 0.8]
        if dup and len(c):
            c = np.concatenate([c, rng.choice(c, 2)])
        rows += [row0 + r] * len(c)
        cols += list(c)
    rows, cols = np.array(rows, dtype=np.int64), np.array(cols, np.int64)
    allele = rng.choice([-1, 1], len(rows))
    weight = rng.integers(1, 41, len(rows))
    perm = rng.permutation(len(rows))
    return rows[perm], cols[perm], allele[perm], weight[perm]


def scrambled(rng, am):
    """The chain phase and blocks, each site's phase then flipped at
    random: many switch errors to repair."""
    phase, block_id, _ = _initial_phase(am)
    return (phase * rng.choice([-1, 1], am.n_sites)).astype(np.int8), block_id


def one_block(rng):
    am = coo(*random_reads(rng, 60, 50, 12), 50)
    return (am, *scrambled(rng, am))


def several_blocks(rng):
    parts = [random_reads(rng, 30, 40, 10, lo=60 * i, row0=30 * i)
             for i in range(4)]
    am = coo(*(np.concatenate(p) for p in zip(*parts)), 240)
    phase, block_id = scrambled(rng, am)
    assert len(np.unique(block_id[block_id >= 0])) >= 4
    return am, phase, block_id


def single_site_blocks(rng):
    """One-site reads on isolated sites (blocks of one site, which the
    correction skips) beside a block of many sites."""
    rows, cols, allele, weight = random_reads(rng, 40, 30, 8)
    lone = np.arange(40, 60, 2)
    am = coo(np.concatenate([rows, 40 + np.arange(len(lone))]),
             np.concatenate([cols, lone]),
             np.concatenate([allele, rng.choice([-1, 1], len(lone))]),
             np.concatenate([weight, rng.integers(1, 41, len(lone))]), 60)
    phase, block_id = scrambled(rng, am)
    sizes = np.bincount(block_id[block_id >= 0])
    assert (sizes == 1).sum() == len(lone) and sizes.max() > 1
    return am, phase, block_id


def trans_chain(n_sites, copies=1):
    """Reads of two adjacent sites, each in trans (+1, -1) at weight 1,
    `copies` times over, under an all-+1 phase: E is the same negative
    integer at every boundary, so every argmin is a tie, and repairing
    them takes a flip a boundary."""
    j = np.tile(np.arange(n_sites - 1), copies)
    rows = np.repeat(np.arange(len(j)), 2)
    cols = np.stack([j, j + 1], axis=1).ravel()
    allele = np.tile([1, -1], len(j))
    am = coo(rows, cols, allele, np.ones(len(rows)), n_sites)
    return am, np.ones(n_sites, dtype=np.int8), np.zeros(n_sites, np.int32)


def ties(rng):
    am, phase, block_id = trans_chain(30, copies=2)
    (_, cols_b, *tables), = list(_block_obs_groups(am, block_id))
    E = _boundary_E(phase, cols_b, *tables)
    assert (E == E.min()).sum() == len(E) > 1
    return am, phase, block_id


def long_reads(rng):
    am = coo(*random_reads(rng, 25, 400, 300, dup=True), 400)
    return (am, *scrambled(rng, am))


def flip_cap(rng):
    """79 boundaries to repair, past the 50-flip cap."""
    return trans_chain(80)


@pytest.fixture(scope="module")
def q10_matrix(tmp_path_factory):
    """The allele matrix of a 300 kb contig simulated at the 10x, ~10%
    error deployment's rates, its sites called by the counting rule."""
    out = str(tmp_path_factory.mktemp("q10"))
    simulate_dataset(out, SimConfig(contigs={"chr21": 300_000}, seed=5,
                                    **Q10))
    store = load_read_store(os.path.join(out, "reads.bam"))
    codes = {"chr21": FastaFile(os.path.join(out, "ref.fa")).fetch_codes(
        "chr21")}
    snps, obs = call_snps_for_store(store, codes)
    return store.contigs["chr21"], snps["chr21"], obs.get("chr21")


CASES = {"one_block": one_block, "several_blocks": several_blocks,
         "single_site_blocks": single_site_blocks, "ties": ties,
         "long_reads": long_reads, "flip_cap": flip_cap}


@pytest.mark.parametrize("case,seed", [
    *[(name, seed) for name in CASES for seed in (0, 1)],
    ("q10_sim", 0), ("q10_sim", 1)])
def test_local_updates_give_the_host_copys_phase(case, seed, request):
    rng = np.random.default_rng(seed)
    if case == "q10_sim":
        cr, snps, obs = request.getfixturevalue("q10_matrix")
        am = tsp.build_allele_matrix(cr, snps, obs=obs)
        assert len(am.row) > 10_000
        phase, block_id = scrambled(rng, am)
    else:
        am, phase, block_id = CASES[case](rng)
    correct = tsp.SwitchCorrector(am, block_id)
    assert correct.exact
    before = phase.copy()
    got = correct(phase)
    np.testing.assert_array_equal(phase, before)      # input left alone
    want = _switch_correct(am, phase, block_id)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(correct(phase, max_flips=3),
                          _switch_correct(am, phase, block_id, 3))
    if case in ("flip_cap", "q10_sim"):
        # the cap binds: without it the correction goes on flipping
        capped = correct(phase).copy(), correct.flips
        free = correct(phase, max_flips=10_000), correct.flips
        assert free[1] > capped[1] and not np.array_equal(free[0], capped[0])
        assert np.array_equal(free[0],
                              _switch_correct(am, phase, block_id, 10_000))


def test_phase_contig_core_unchanged_through_its_rounds(q10_matrix,
                                                        monkeypatch):
    """Every round's correction equals the host copy's on the phase that
    round is given, and the contig's (phase, block_id, block_ps) equal
    those of the loop run with the host copy."""
    cr, snps, obs = q10_matrix
    rounds = []

    class Checked(tsp.SwitchCorrector):
        def __call__(self, phase, max_flips=50):
            got = super().__call__(phase, max_flips)
            want = _switch_correct(self.am, phase, self.block_id, max_flips)
            rounds.append((np.array_equal(got, want), self.flips))
            return got

    class HostCopy(tsp.SwitchCorrector):
        def __call__(self, phase, max_flips=50):
            return _switch_correct(self.am, phase, self.block_id, max_flips)

    spans.reset("snp_phasing.")
    monkeypatch.setattr(tsp, "SwitchCorrector", Checked)
    _, *local = tsp.phase_contig_core(cr, snps, obs=obs)
    counters = spans.snapshot("snp_phasing.")["counters"]
    monkeypatch.setattr(tsp, "SwitchCorrector", HostCopy)
    _, *host = tsp.phase_contig_core(cr, snps, obs=obs)
    assert rounds and all(same for same, _ in rounds)
    assert sum(flips for _, flips in rounds) > 0
    assert counters == {"snp_phasing.switch_correct_fallbacks": 0,
                        "snp_phasing.correct_rounds": len(rounds),
                        "snp_phasing.switch_flips":
                            sum(flips for _, flips in rounds)}
    for a, b in zip(local, host):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("weight", [30.5, np.nan, 2.0 ** 40])
def test_an_inexact_contig_takes_the_host_copy(weight):
    """A non-integral weight, or one whose sums could pass 2**53, takes
    the host copy, with the same phase."""
    rng = np.random.default_rng(3)
    am, phase, block_id = one_block(rng)
    am.weight[len(am.weight) // 2] = weight
    correct = tsp.SwitchCorrector(am, block_id)
    assert not correct.exact and not correct.blocks
    np.testing.assert_array_equal(correct(phase),
                                  _switch_correct(am, phase, block_id))
