"""The port's fused phasing + scoring (``phase_and_tag_fused``), its
precomputed-aw scorer (``haplotag_score``) and the plain sweep
(``power_sweep_votes``) against the JAX package's Pallas kernels, run in
interpret mode on the CPU as tests/test_pallas_haplotag.py runs them.  On
the CPU the wrappers run their kernels' plain versions; tests/test_torch_cuda.py
holds the kernels' tests on the card.  Every comparison is exact: all sums
are integers below 2^24."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
import chip_smoke
from duet_tpu.ops.pallas_haplotag import (
    haplotag_score_pallas,
)
from duet_tpu.ops.pallas_haplotag import (
    phase_and_tag_fused as jax_fused,
)
from duet_tpu_torch.ops import haplotag_kernel
from duet_tpu_torch.ops.haplotag import (
    haplotag_score_plain,
    phase_and_tag,
    power_sweep_votes,
)

INTERPRET = jax.default_backend() != "tpu"
KEYS = ("hap", "pc", "best_block", "phase")


def _torch_args(alleles, weights, phase0, onehot):
    return (torch.from_numpy(alleles),
            torch.from_numpy(weights).to(torch.bfloat16),
            torch.from_numpy(phase0), torch.from_numpy(onehot))


def _jax_fused(alleles, weights, phase0, onehot, sweeps):
    return jax_fused(jnp.asarray(alleles), jnp.asarray(weights, jnp.bfloat16),
                     jnp.asarray(phase0), jnp.asarray(onehot), sweeps=sweeps,
                     interpret=INTERPRET)


def _assert_fused_equal(alleles, weights, phase0, onehot, sweeps):
    want = _jax_fused(alleles, weights, phase0, onehot, sweeps)
    args = _torch_args(alleles, weights, phase0, onehot)
    before = dict(haplotag_kernel.LAUNCHES)
    got = haplotag_kernel.phase_and_tag_fused(*args, sweeps=sweeps)
    assert haplotag_kernel.LAUNCHES == before   # no kernel on the CPU
    plain = phase_and_tag(*args, sweeps=sweeps)
    for key in KEYS:
        assert got[key].dtype == (torch.int8 if key == "phase"
                                  else torch.int32), key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
        np.testing.assert_array_equal(got[key].numpy(), plain[key].numpy(),
                                      err_msg=f"{key} vs plain")
    return got


@pytest.mark.parametrize("R,S,B,sweeps", [
    (300, 200, 5, 2), (1024, 512, 16, 2), (257, 129, 3, 3), (512, 256, 8, 0),
    (300, 300, 200, 2),
])
def test_fused_matches_jax_pallas(R, S, B, sweeps):
    alleles, weights, phase0, onehot = g._example_batch(R=R, S=S, B=B, seed=R)
    got = _assert_fused_equal(alleles, weights, phase0, onehot, sweeps)
    if B > 126:
        assert int(got["best_block"].max()) > 126


def test_fused_keeps_uncovered_sites_zero():
    """Sites whose initial phase is 0 stay 0 through every sweep; rows
    with no allele score untagged."""
    alleles, weights, phase0, onehot = g._example_batch(R=384, S=160, B=6,
                                                        seed=12)
    phase0[::7] = 0.0
    alleles[:20] = 0
    weights[:20] = 0.0
    got = _assert_fused_equal(alleles, weights, phase0, onehot, 3)
    assert (got["phase"].numpy()[::7] == 0).all()
    assert (got["hap"].numpy()[:20] == 0).all()


@pytest.mark.parametrize("R,S,B", [(300, 256, 5), (256, 128, 1),
                                   (700, 512, 33), (300, 300, 200)])
def test_haplotag_score_matches_jax_pallas(R, S, B):
    alleles, weights, phase0, onehot = g._example_batch(R=R, S=S, B=B, seed=R)
    want = haplotag_score_pallas(alleles, weights, phase0, onehot,
                                 interpret=INTERPRET)
    args = (torch.from_numpy(alleles), torch.from_numpy(weights),
            torch.from_numpy(phase0), torch.from_numpy(onehot))
    got = haplotag_kernel.haplotag_score(*args)
    plain = phase_and_tag(*args, sweeps=0)
    for k, key in enumerate(("hap", "pc", "best_block")):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=key)
        np.testing.assert_array_equal(got[k].numpy(), plain[key].numpy(),
                                      err_msg=f"{key} vs plain")


def test_haplotag_score_plain_reads_the_given_abs():
    """The _kernel twin takes |aw| as given, not recomputed from aw."""
    alleles, weights, phase0, onehot = g._example_batch(R=64, S=128, B=4,
                                                        seed=3)
    aw = torch.from_numpy(alleles).to(torch.bfloat16) * \
        torch.from_numpy(weights).to(torch.bfloat16)
    rhs = torch.zeros((128, 6), dtype=torch.bfloat16)
    rhs[:, 0] = torch.from_numpy(phase0)
    rhs[:, 1] = 1
    rhs[:, 2:] = torch.from_numpy(onehot)
    hap, _, _ = haplotag_score_plain(aw, aw.abs(), rhs, 4)
    hap0, _, _ = haplotag_score_plain(aw, torch.zeros_like(aw), rhs, 4)
    assert (hap != 0).any() and (hap0 == 0).all()   # total 0 -> untagged


@pytest.mark.parametrize("seed", [0, 1])
def test_power_sweep_votes_match_numpy_and_jax(seed):
    alleles, weights, phase0, onehot = g._example_batch(R=520, S=300, B=4,
                                                        seed=seed)
    phase0[::5] = 0.0
    aw = alleles.astype(np.float32) * weights
    want = aw.T @ np.sign(aw @ phase0)
    a, w16, ph, _ = _torch_args(alleles, weights, phase0, onehot)
    votes = power_sweep_votes(a, w16, ph.to(torch.bfloat16))
    assert votes.dtype == torch.float32
    np.testing.assert_array_equal(votes.numpy(), want)
    assert haplotag_kernel.power_sweep(a, w16, ph.to(torch.bfloat16)) \
        .equal(votes)
    # the phase after one sweep, by the JAX kernel's update rule
    new = np.where(want > 0, 1, np.where(want < 0, -1, phase0))
    new = np.where(phase0 != 0, new, 0).astype(np.int8)
    jax_phase = _jax_fused(alleles, weights, phase0, onehot, 1)["phase"]
    np.testing.assert_array_equal(np.asarray(jax_phase), new)


@pytest.mark.parametrize("R,S,kind", [
    shape for shape in chip_smoke.SWEEP_EDGE_SHAPES
    if shape[0] * shape[1] <= 10**6])
def test_sweep_edge_shapes_match_numpy_and_jax(R, S, kind):
    """chip_smoke.py's sweep edge shapes that fit the CPU: the plain sweep
    (what a CPU tensor runs, and what the kernel is pinned to on the card)
    equals numpy, and its one-sweep phase equals the JAX kernel's."""
    alleles, weights, phase0 = chip_smoke.sweep_edge_batch(R, S, kind)
    aw = alleles.astype(np.float32) * weights
    want = aw.T @ np.sign(aw @ phase0)
    a = torch.from_numpy(alleles)
    w16 = torch.from_numpy(weights).to(torch.bfloat16)
    ph16 = torch.from_numpy(phase0).to(torch.bfloat16)
    votes = haplotag_kernel.power_sweep(a, w16, ph16)
    np.testing.assert_array_equal(votes.numpy(), want)
    assert votes.equal(power_sweep_votes(a, w16, ph16))
    if kind == "cancel":
        assert not want.any()
    onehot = np.ones((S, 1), np.float32)
    new = np.where(want > 0, 1, np.where(want < 0, -1, phase0))
    new = np.where(phase0 != 0, new, 0).astype(np.int8)
    jax_phase = _jax_fused(alleles, weights, phase0, onehot, 1)["phase"]
    np.testing.assert_array_equal(np.asarray(jax_phase), new)


@pytest.mark.parametrize("case", ["f32_weights", "f32_phase", "phase_len",
                                  "int16_alleles"])
def test_fused_wrappers_reject_bad_inputs(case):
    alleles, weights, phase0, onehot = g._example_batch(R=64, S=128, B=2,
                                                        seed=0)
    a, w16, ph, oh = _torch_args(alleles, weights, phase0, onehot)
    if case == "f32_weights":      # as the JAX function, a TypeError
        with pytest.raises(TypeError):
            haplotag_kernel.phase_and_tag_fused(a, w16.float(), ph, oh)
        return
    ph16 = ph.to(torch.bfloat16)
    if case == "f32_phase":
        ph16 = ph
    elif case == "phase_len":
        ph16 = ph16[:-1]
    elif case == "int16_alleles":
        a = a.to(torch.int16)
    with pytest.raises(TypeError):
        haplotag_kernel.power_sweep(a, w16, ph16)
