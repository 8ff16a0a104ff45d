"""SV clustering of the torch port against the JAX kernel and the numpy
host path: gap and span linkage, several SV types in one pass, and float32
span-ratio ties.  Exact equality."""

import numpy as np
import pytest
import torch

from duet_tpu.ops import cluster as jc
from duet_tpu_torch.ops import cluster as tc
from test_cluster_kernel import random_signatures

CPU = torch.device("cpu")
MD_BY_TYPE = (100, 200, 200, 200)
NAMES = ("call_pos", "call_len", "support", "count", "seg", "call_type")


def typed_signatures(seed, k):
    rng = np.random.default_rng(seed)
    pos, length, read_idx = random_signatures(rng, k=k)
    svtype = rng.integers(0, 4, k).astype(np.int32)
    return svtype, pos, length, read_idx


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("linkage,num,den", [
    (tc.GAP, 9, 10), (tc.SPAN, 9, 10), (tc.SPAN, 3, 10),
])
def test_device_matches_jax_and_host(seed, linkage, num, den):
    svtype, pos, length, read_idx = typed_signatures(seed, 40 + 50 * seed)
    args = (svtype, pos, length, read_idx, linkage, MD_BY_TYPE, num, den)
    want = jc.cluster_multi(*args, device=True)
    host = jc.cluster_host_multi(*args)
    got = tc.cluster_multi(*args, device=True, torch_device=CPU)
    for g, w, h, name in zip(got, want, host, NAMES):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(g, h, err_msg=f"{name} vs host")


def test_host_copy_matches_jax_host():
    svtype, pos, length, read_idx = typed_signatures(9, 300)
    args = (svtype, pos, length, read_idx, tc.GAP, MD_BY_TYPE, 9, 10)
    for g, w, name in zip(tc.cluster_host_multi(*args),
                          jc.cluster_host_multi(*args), NAMES):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_span_float32_ties():
    """(|dpos| + |dlen|) * den == max_len * num exactly: the strict '>'
    keeps the pair linked, identically on every path."""
    # pairs: dpos 45 + dlen 45 = 90, max len 100 -> 90*10 == 100*9
    pos = np.array([1000, 1045, 5000, 5046], dtype=np.int64)
    length = np.array([55, 100, 55, 100], dtype=np.int64)
    read_idx = np.array([0, 1, 2, 3], dtype=np.int64)
    svtype = np.zeros(4, dtype=np.int32)
    args = (svtype, pos, length, read_idx, tc.SPAN, MD_BY_TYPE, 9, 10)
    got = tc.cluster_multi(*args, device=True, torch_device=CPU)
    want = jc.cluster_multi(*args, device=True)
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    # the tie links (one cluster), the one-off pair breaks
    np.testing.assert_array_equal(got[3], [2, 1, 1])


def test_empty_and_single():
    e = np.zeros(0, dtype=np.int64)
    out = tc.cluster_multi(e.astype(np.int32), e, e, e, tc.GAP, MD_BY_TYPE,
                           9, 10, device=True, torch_device=CPU)
    assert all(len(a) == 0 for a in out)
    one = tc.cluster_multi(np.array([1], np.int32), np.array([5]),
                           np.array([100]), np.array([7]), tc.GAP,
                           MD_BY_TYPE, 9, 10, device=True, torch_device=CPU)
    assert (one[0][0], one[1][0], one[2][0], one[5][0]) == (5, 100, 1, 1)
