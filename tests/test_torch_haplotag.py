"""Dense K1 haplotag scoring of the torch port against the JAX package:
the plain torch ``phase_and_tag_batch`` / ``phase_and_tag`` against the JAX
functions and the Pallas kernel (interpret mode on the CPU), and the kernel
wrapper's CPU route and input checks (tests/test_torch_cuda.py holds the
kernel's tests on the card).  All comparisons are exact: every sum is an
integer below 2^24."""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from duet_tpu.ops import haplotag as jax_haplotag
from duet_tpu.ops.pallas_haplotag import TILE_R, haplotag_score_batch_pallas
from duet_tpu_torch.ops import haplotag_kernel
from duet_tpu_torch.ops.haplotag import phase_and_tag, phase_and_tag_batch

INTERPRET = jax.default_backend() != "tpu"


def batch_inputs(seed, T=3, S=256, B=126, tie=False):
    """The construction of tests/test_pallas_haplotag.py's batched case;
    `tie` adds reads whose weight splits equally over two blocks."""
    A = np.zeros((T * TILE_R, S), np.int8)
    W = np.zeros((T * TILE_R, S), np.float32)
    rhs = np.zeros((T * S, 2 + B), np.float32)
    for k in range(T):
        a, w, ph, oh = g._example_batch(R=TILE_R, S=S, B=B, seed=seed + k)
        if tie:
            oh[:] = 0
            oh[: S // 2, 3] = 1
            oh[S // 2:, 7] = 1
            for r in range(0, TILE_R, 4):   # equal mass in blocks 3 and 7
                a[r] = 0
                a[r, [1, 2, S // 2 + 1, S // 2 + 2]] = [1, -1, 1, 1]
                w[r] = 0
                w[r, [1, 2, S // 2 + 1, S // 2 + 2]] = 25
        A[k * TILE_R:(k + 1) * TILE_R] = a
        W[k * TILE_R:(k + 1) * TILE_R] = w
        rhs[k * S:(k + 1) * S, 0] = ph
        rhs[k * S:(k + 1) * S, 1] = ph != 0
        rhs[k * S:(k + 1) * S, 2:] = oh
    return A, W, rhs, T, B


@pytest.mark.parametrize("seed,tie", [(5, False), (40, False), (9, True)])
def test_batch_matches_jax_and_pallas(seed, tie):
    A, W, rhs, T, B = batch_inputs(seed, tie=tie)
    W16 = W.astype(ml_dtypes.bfloat16)
    rhs16 = rhs.astype(ml_dtypes.bfloat16)
    hap_j, pc_j, best_j = jax_haplotag.phase_and_tag_batch(
        A, W16, rhs16, n_tasks=T, n_blocks=B)
    packed = np.asarray(haplotag_score_batch_pallas(
        A, W16, rhs16, n_tasks=T, n_blocks=B, interpret=INTERPRET))
    got = phase_and_tag_batch(torch.from_numpy(A),
                              torch.from_numpy(W).to(torch.bfloat16),
                              torch.from_numpy(rhs).to(torch.bfloat16),
                              T, B)
    for k, (name, want) in enumerate(zip(("hap", "pc", "best"),
                                         (hap_j, pc_j, best_j))):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want),
                                      err_msg=name)
        np.testing.assert_array_equal(got[k].numpy(), packed[:, k],
                                      err_msg=f"{name} vs pallas")
    if tie:
        # the first of two equally heavy blocks wins
        assert (got[2].numpy()[::4] == 3).all()


@pytest.mark.parametrize("R,S,B,sweeps", [
    (300, 256, 5, 0), (300, 200, 5, 2), (257, 129, 3, 2), (512, 256, 8, 0),
])
def test_phase_and_tag_matches_jax(R, S, B, sweeps):
    alleles, weights, phase0, onehot = g._example_batch(R=R, S=S, B=B, seed=R)
    want = jax_haplotag.phase_and_tag(alleles, weights, phase0, onehot,
                                      sweeps=sweeps)
    got = phase_and_tag(torch.from_numpy(alleles), torch.from_numpy(weights),
                        torch.from_numpy(phase0), torch.from_numpy(onehot),
                        sweeps=sweeps)
    for key in ("hap", "pc", "best_block", "signed", "total", "phase"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


def test_batch_wide_rhs_matches_pallas():
    """K = 256 (two 128-column slabs in the kernel): the wrapper equals the
    Pallas kernel and its jnp twin, with best blocks past column 128."""
    A, W, rhs, T, B = batch_inputs(21, T=2, S=256, B=254)
    W16 = W.astype(ml_dtypes.bfloat16)
    rhs16 = rhs.astype(ml_dtypes.bfloat16)
    hap_j, pc_j, best_j = jax_haplotag.phase_and_tag_batch(
        A, W16, rhs16, n_tasks=T, n_blocks=B)
    packed = np.asarray(haplotag_score_batch_pallas(
        A, W16, rhs16, n_tasks=T, n_blocks=B, interpret=INTERPRET))
    got = haplotag_kernel.haplotag_score_batch(
        torch.from_numpy(A), torch.from_numpy(W).to(torch.bfloat16),
        torch.from_numpy(rhs).to(torch.bfloat16), T, B)
    for k, want in enumerate((hap_j, pc_j, best_j)):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))
        np.testing.assert_array_equal(got[k].numpy(), packed[:, k])
    assert got[2].max() > 126


def test_wrapper_takes_plain_version_on_cpu():
    A, W, rhs, T, B = batch_inputs(3)
    args = (torch.from_numpy(A), torch.from_numpy(W).to(torch.bfloat16),
            torch.from_numpy(rhs).to(torch.bfloat16))
    before = dict(haplotag_kernel.LAUNCHES)
    got = haplotag_kernel.haplotag_score_batch(*args, T, B)
    want = phase_and_tag_batch(*args, T, B)
    assert haplotag_kernel.LAUNCHES == before   # no kernel on the CPU
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["f32_weights", "rows", "rhs_rows",
                                  "narrow_k", "no_blocks", "strided"])
def test_wrapper_rejects_bad_inputs(case):
    A, W, rhs, T, B = batch_inputs(3, T=2, S=128, B=10)
    a = torch.from_numpy(A)
    w = torch.from_numpy(W).to(torch.bfloat16)
    r = torch.from_numpy(rhs).to(torch.bfloat16)
    n_tasks, n_blocks = T, B
    if case == "f32_weights":
        w = w.float()
    elif case == "rows":
        n_tasks = 3
    elif case == "rhs_rows":
        r = r[:-1]
    elif case == "narrow_k":          # no column left for a block
        r = torch.zeros((T * 128, 2), dtype=torch.bfloat16)
    elif case == "no_blocks":
        n_blocks = 0
    elif case == "strided":
        a = a.T.contiguous().T
    with pytest.raises((TypeError, ValueError)):
        haplotag_kernel.haplotag_score_batch(a, w, r, n_tasks, n_blocks)
