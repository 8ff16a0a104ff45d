"""The neural caller's candidate gate and feature windows of the torch
port (``ops.snp_features``) against duet_tpu's numpy ``candidate_sites``
and ``extract_features``: the twins the card's kernels are pinned to, and
``nn_call_snps``' two routes.  Exact: the candidates field for field, the
features byte for byte."""

import numpy as np
import pytest
import torch

import chip_smoke
from duet_tpu.models import nn_snp as jnn
from duet_tpu_torch.models import nn_snp as tnn
from duet_tpu_torch.ops import snp_features as sf
from duet_tpu_torch.utils import dispatch, spans
from test_torch_nn_snp import sim_counts
from test_torch_pileup import _CudaTyped

CPU = torch.device("cpu")
FIELDS = ("pos", "ref_code", "alt_code", "is_het", "depth", "alt_count")
CASES = ["sim", "sim_int32", "cell_shape", *chip_smoke.SNP_FEATURE_EDGE_CASES]


def image(case, sim_dataset):
    """((L, 4) counts, (L,) uint8 reference codes) of a case: the
    simulator's (the numpy counting's int64, or int32 as the native
    counting gives), a stretch shaped like the q10-10x cell, or an edge
    case of chip_smoke.SNP_FEATURE_EDGE_CASES."""
    if case.startswith("sim"):
        counts, codes = sim_counts(sim_dataset)
        if case == "sim_int32":
            counts = counts.astype(np.int32)
        return counts, codes
    if case == "cell_shape":
        return chip_smoke.snp_feature_counts(200_000, 5)
    return chip_smoke.snp_feature_edge_inputs(case)


def assert_bytes_equal(got: np.ndarray, want: np.ndarray):
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("case", CASES)
def test_twins_match_duet_tpu(sim_dataset, case):
    counts, codes = image(case, sim_dataset)
    want = jnn.candidate_sites(counts, codes)
    got = sf.candidates(torch.from_numpy(counts), torch.from_numpy(codes))
    for name, g, w in zip(("pos", "alt_code", "alt_count", "depth"), got,
                          want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert [g.dtype for g in got] == [torch.int64, torch.uint8, torch.int32,
                                      torch.int64]
    pos, alt = want[0], want[1]
    feats = sf.features(torch.from_numpy(counts), torch.from_numpy(codes),
                        got[0], got[1]).numpy()
    assert_bytes_equal(feats, jnn.extract_features(counts, codes, pos, alt))
    if case == "none":
        assert len(pos) == 0 and feats.shape == (0, sf.N_FEATURES)
    elif case in ("edges", "short"):
        L = len(codes)
        assert {0, 1, L - 2, L - 1} <= set(pos.tolist())
    elif case == "ties":
        c = counts[pos].astype(np.int64)
        c[np.arange(len(pos)), np.minimum(codes[pos], 3)] = -1
        assert ((c == c.max(axis=1, keepdims=True)).sum(axis=1) > 1).any()
    elif case == "deep":
        assert (counts[pos].sum(axis=1) > 100).any()
    elif case == "ref_n":
        assert (codes >= 4).any() and (codes[pos] < 4).all()


@pytest.mark.parametrize("batch", [7, 1000, 65536])
def test_chunked_features_match_duet_tpu(sim_dataset, batch):
    """Features made a chunk at a time, with chunk sizes that do not
    divide n, join to extract_features of all the candidates."""
    counts, codes = sim_counts(sim_dataset)
    pos, alt, _, _ = jnn.candidate_sites(counts, codes)
    assert len(pos) % batch
    c, r = torch.from_numpy(counts), torch.from_numpy(codes)
    p, a = torch.from_numpy(pos), torch.from_numpy(alt)
    got = torch.cat([sf.features(c, r, p[s:s + batch], a[s:s + batch])
                     for s in range(0, len(pos), batch)]).numpy()
    assert_bytes_equal(got, jnn.extract_features(counts, codes, pos, alt))


def assert_snps_equal(got, want):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        np.testing.assert_array_equal(g, w, err_msg=f)
        assert g.dtype == w.dtype, f


def test_nn_call_snps_on_the_cpu_takes_the_host_route(sim_dataset):
    """On the CPU the numpy route runs, is recorded as
    dispatch.snp_features.host with its candidates counted, and gives
    duet_tpu's calls."""
    counts, codes = sim_counts(sim_dataset)
    spans.reset()
    got = tnn.nn_call_snps("chr21", counts, codes, batch=1000)
    snap = spans.snapshot()["counters"]
    assert dispatch.snapshot()["snp_features"] == {"host": 1}
    assert snap["snp_calling.candidates"] == \
        len(jnn.candidate_sites(counts, codes)[0])
    assert len(got.pos) > 0
    assert_snps_equal(got, jnn.nn_call_snps("chr21", counts, codes))


@pytest.mark.parametrize("case,batch", [("sim", 1000), ("sim_int32", 777),
                                        ("none", 1000), ("edges", 5)])
def test_card_route_on_cpu_tensors_matches_the_host_route(sim_dataset, case,
                                                          batch):
    """The card route's glue (upload, candidates, chunked features and
    forward, the compaction of the called sites and their one readback)
    run on CPU tensors, where the wrappers take the twins: the same
    ContigSnps, dtypes included, as the host route."""
    counts, codes = image(case, sim_dataset)
    spans.reset()
    got = tnn._nn_call_snps_card("chr21", counts, codes, None, CPU, batch)
    assert dispatch.snapshot()["snp_features"] == {"kernel": 1}
    n = len(jnn.candidate_sites(counts, codes)[0])
    assert spans.snapshot()["counters"]["snp_calling.candidates"] == n
    want = tnn.nn_call_snps("chr21", counts, codes, batch=batch)
    assert_snps_equal(got, want)
    if case.startswith("sim"):
        assert len(got.pos) > 0


def test_cpu_wrappers_count_no_launch(sim_dataset):
    counts, codes = image("ties", sim_dataset)
    sf.reset_launches()
    c, r = torch.from_numpy(counts), torch.from_numpy(codes)
    pos, alt, _, _ = sf.candidates(c, r)
    sf.features(c, r, pos, alt)
    assert sf.LAUNCHES == dict.fromkeys(sf.KERNELS, 0)


def test_cuda_tensor_raises_when_the_library_fails(monkeypatch):
    """CUDA tensors go to the kernels: when the library cannot be built
    each wrapper raises, and neither falls back to its twin nor counts a
    launch."""
    def no_library():
        raise RuntimeError("nvcc not found")

    def no_plain(*args, **kwargs):
        raise AssertionError("fell back to the twin")

    monkeypatch.setattr(sf, "_library", no_library)
    monkeypatch.setattr(sf, "candidates_plain", no_plain)
    monkeypatch.setattr(sf, "features_plain", no_plain)
    counts, codes = chip_smoke.snp_feature_edge_inputs("ties")
    c = torch.Tensor._make_subclass(_CudaTyped, torch.from_numpy(counts))
    r = torch.Tensor._make_subclass(_CudaTyped, torch.from_numpy(codes))
    pos = torch.Tensor._make_subclass(_CudaTyped,
                                      torch.arange(4, dtype=torch.int64))
    alt = torch.Tensor._make_subclass(_CudaTyped,
                                      torch.ones(4, dtype=torch.uint8))
    assert c.device.type == "cuda"
    sf.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        sf.candidates(c, r)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        sf.features(c, r, pos, alt)
    assert sf.LAUNCHES == dict.fromkeys(sf.KERNELS, 0)


def test_nn_call_snps_on_cuda_without_a_card_raises(sim_dataset):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    counts, codes = sim_counts(sim_dataset)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnn.nn_call_snps("chr21", counts, codes,
                         device=torch.device("cuda"))


@pytest.mark.parametrize("bad", ["float_counts", "wide_counts", "short_ref",
                                 "ref_dtype", "strided", "pos_dtype",
                                 "alt_length"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    counts, codes = chip_smoke.snp_feature_edge_inputs("ties")
    c, r = torch.from_numpy(counts), torch.from_numpy(codes)
    pos, alt = torch.arange(3), torch.zeros(3, dtype=torch.uint8)
    if bad == "float_counts":
        c = c.float()
    elif bad == "wide_counts":
        c = torch.zeros((len(r), 5), dtype=torch.int32)
    elif bad == "short_ref":
        r = r[:-1]
    elif bad == "ref_dtype":
        r = r.int()
    elif bad == "strided":
        c = torch.zeros((len(r), 8), dtype=torch.int32)[:, ::2]
    elif bad == "pos_dtype":
        pos = pos.int()
    elif bad == "alt_length":
        alt = alt[:2]
    with pytest.raises((TypeError, ValueError)):
        sf.candidates(c, r)
        sf.features(c, r, pos, alt)
