"""Tests of the torch port that need a CUDA card; they skip on a host
without one.  This file imports no jax, so it also runs on a GPU machine
that has none:

    DUET_TPU_TEST_REAL=1 python -m pytest tests/test_torch_cuda.py -q

(DUET_TPU_TEST_REAL keeps tests/conftest.py from pinning jax to the CPU.)
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from duet_tpu_torch.bench import make_batch
from duet_tpu_torch.ops import haplotag_kernel, pileup_kernel
from duet_tpu_torch.ops.pileup import (
    call_plain,
    count_plain,
    packed_window_body,
)
from duet_tpu_torch.ops.haplotag import (
    haplotag_score_plain,
    phase_and_tag,
    phase_and_tag_batch,
    power_sweep_votes,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", ["pipeline_shape", "edge_1", "edge_2"])
def test_kernel_matches_plain(cuda_device, case):
    """The hand kernel against the plain version on the card, at the
    pipeline's launch shape and on chip_smoke.py's edge cases."""
    if case == "pipeline_shape":
        A, W, rhs = chip_smoke.pipeline_shaped_inputs(seed=3)
        T, B = 16, 126
    else:
        A, W, rhs, T, B = chip_smoke.edge_case_inputs(int(case[-1]))
    a = torch.from_numpy(A).to(cuda_device)
    w = torch.from_numpy(W).to(torch.bfloat16).to(cuda_device)
    r = torch.from_numpy(rhs).to(torch.bfloat16).to(cuda_device)
    before = haplotag_kernel.LAUNCHES["haplotag_score"]
    got = haplotag_kernel.haplotag_score_batch(a, w, r, T, B)
    want = phase_and_tag_batch(a, w, r, T, B)
    torch.cuda.synchronize()
    assert haplotag_kernel.LAUNCHES["haplotag_score"] == before + 1
    for name, x, y in zip(("hap", "pc", "best"), got, want):
        assert x.device == cuda_device and x.dtype == torch.int32
        assert torch.equal(x, y), name


@pytest.mark.parametrize("K", [130, 256])
def test_kernel_wide_rhs_matches_plain(cuda_device, K):
    """rhs wider than one 128-column slab of the kernel."""
    A, W, rhs = chip_smoke.pipeline_shaped_inputs(K, 3, 200, 700, K, K - 2)
    a = torch.from_numpy(A).to(cuda_device)
    w = torch.from_numpy(W).to(torch.bfloat16).to(cuda_device)
    r = torch.from_numpy(rhs).to(torch.bfloat16).to(cuda_device)
    got = haplotag_kernel.haplotag_score_batch(a, w, r, 3, K - 2)
    want = phase_and_tag_batch(a, w, r, 3, K - 2)
    torch.cuda.synchronize()
    for name, x, y in zip(("hap", "pc", "best"), got, want):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("K,S,rows", chip_smoke.SCORE_EDGE_SHAPES)
def test_score_kernels_on_edge_shapes(cuda_device, K, S, rows):
    """Both score entries against their plain versions with K below, at and
    above one n8 tile and one 128-column slab, S off the 64-site stage and
    the 16-byte copy, rows off the row tiles, and all-zero rows, tied
    blocks and negative signed sums in every task."""
    T = 3
    A, W, rhs = chip_smoke.score_edge_inputs(K + S + rows, T, rows, S, K)
    a = torch.from_numpy(A).to(cuda_device)
    w = torch.from_numpy(W).to(torch.bfloat16).to(cuda_device)
    r = torch.from_numpy(rhs).to(torch.bfloat16).to(cuda_device)
    got = haplotag_kernel.haplotag_score_batch(a, w, r, T, K - 2)
    want = phase_and_tag_batch(a, w, r, T, K - 2)
    aw = a[:rows].to(torch.bfloat16) * w[:rows]
    r0 = r[:S].contiguous()
    got_pre = haplotag_kernel.haplotag_score_pre(aw, aw.abs(), r0, K - 2)
    want_pre = haplotag_score_plain(aw, aw.abs(), r0, K - 2)
    torch.cuda.synchronize()
    for name, x, y in zip(("hap", "pc", "best"), got, want):
        assert torch.equal(x, y), name
    for name, x, y in zip(("hap", "pc", "best"), got_pre, want_pre):
        assert torch.equal(x, y), f"precomputed aw {name}"
    assert (got[0][::rows] == 0).all()          # the all-zero rows


@pytest.mark.parametrize("scale", [1, 40])
@pytest.mark.parametrize("case", chip_smoke.PILEUP_EDGE_CASES)
def test_pileup_kernels_match_plain(cuda_device, case, scale):
    """Both pileup kernels against their plain versions on the card, on
    chip_smoke.py's edge cases: the bins with their sentinel, then the
    whole flat output (slots past the sites included), each kernel once;
    packed_window_body on CUDA tensors runs the kernels; and the count
    kernel sends the ops that second_path_ops names off its tiles."""
    ops4, payload, total, L, max_sites = chip_smoke.pileup_edge_inputs(
        case, scale)
    o = torch.from_numpy(ops4).to(cuda_device)
    p = torch.from_numpy(payload).to(cuda_device)
    ref = p[p.shape[0] - L:]
    before = dict(pileup_kernel.LAUNCHES)
    bins = pileup_kernel.pileup_count(o, p, total=total, length=L)
    out = pileup_kernel.pileup_call(bins, ref, o[3], max_sites)
    torch.cuda.synchronize()
    assert {k: pileup_kernel.LAUNCHES[k] - before[k]
            for k in pileup_kernel.KERNELS} == {"pileup_count": 1,
                                                "pileup_call": 1}
    want_bins = count_plain(o, p, total=total, length=L)
    assert bins.dtype == torch.int32 and torch.equal(bins, want_bins)
    want = call_plain(want_bins, ref, o[3], max_sites)
    assert out.device == cuda_device and torch.equal(out, want)
    got = packed_window_body(o, p, total=total, length=L,
                             max_sites=max_sites)
    assert torch.equal(got, want)
    assert pileup_kernel.LAUNCHES["pileup_count"] == \
        before["pileup_count"] + 2
    bins, seen = pileup_kernel.pileup_count_report(o, p, total=total,
                                                   length=L)
    assert torch.equal(bins, want_bins)
    assert seen["second_path_ops"] == pileup_kernel.second_path_ops(
        o, p, total=total, length=L)
    assert seen["tile_positions"] == pileup_kernel.tile_positions()


def _small_batch(seed, B):
    """Shapes off every tile size on the card: chip_smoke.py's sweep edge
    case (B = 5: all-zero rows, zero-phase sites), else a denser batch."""
    batch = chip_smoke.sweep_edge_inputs(seed) if B == 5 else \
        make_batch(1000, 777, B, density=0.1, seed=seed)
    return chip_smoke._cuda(*batch)


@pytest.mark.parametrize("seed,B", [(1, 5), (2, 5), (3, 40)])
def test_sweep_kernel_matches_plain(cuda_device, seed, B):
    a, _, w16, p, _ = _small_batch(seed, B)
    p16 = p.to(torch.bfloat16)
    before = haplotag_kernel.LAUNCHES["haplotag_sweep"]
    got = haplotag_kernel.power_sweep(a, w16, p16)
    want = power_sweep_votes(a, w16, p16)
    torch.cuda.synchronize()
    assert haplotag_kernel.LAUNCHES["haplotag_sweep"] == before + 1
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("R,S,kind", chip_smoke.SWEEP_EDGE_SHAPES)
def test_sweep_kernel_on_edge_shapes(cuda_device, R, S, kind):
    """Both arms of the sweep kernel against the plain version, exactly: R
    off a tile's rows, S off the 16-byte copies and past the one-CTA row
    limit, all-zero rows, zero-phase sites, a window of zero row sums and
    votes near 2^24."""
    A, W, phase = chip_smoke.sweep_edge_batch(R, S, kind)
    a = torch.from_numpy(A).to(cuda_device)
    w16 = torch.from_numpy(W).to(torch.bfloat16).to(cuda_device)
    p16 = torch.from_numpy(phase).to(torch.bfloat16).to(cuda_device)
    before = haplotag_kernel.LAUNCHES["haplotag_sweep"]
    got = haplotag_kernel.power_sweep(a, w16, p16)
    want = power_sweep_votes(a, w16, p16)
    torch.cuda.synchronize()
    assert haplotag_kernel.LAUNCHES["haplotag_sweep"] == before + 1
    assert torch.equal(got, want)
    if kind == "cancel":
        assert not got.any()
    arm = "one_pass" if S <= chip_smoke.SWEEP_ROW_LIMIT else "reread"
    assert haplotag_kernel.sweep_launch_shape(R, S)["arm"] == arm


def test_sweep_launch_shape(cuda_device):
    """The bench and quick windows take the one-pass arm with 8-row tiles,
    16-byte copies and a grid no larger than its tiles; the row limit
    splits the arms."""
    from duet_tpu_torch.bench import KERNEL_SHAPE

    for R, S, _ in KERNEL_SHAPE.values():
        shape = haplotag_kernel.sweep_launch_shape(R, S)
        assert shape["arm"] == "one_pass" and shape["rows"] == 8, shape
        assert shape["copy"] == "cp.async" and shape["cluster"] == 1, shape
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        assert shape["ctas"] == min(R // 8, shape["ctas_per_sm"] * n_sm)
    assert haplotag_kernel.sweep_launch_shape(1, 15)["copy"] == "element"
    limit = chip_smoke.SWEEP_ROW_LIMIT
    assert haplotag_kernel.sweep_launch_shape(1, limit)["rows"] == 1
    assert haplotag_kernel.sweep_launch_shape(1, limit + 1)["arm"] == \
        "reread"


@pytest.mark.parametrize("B,sweeps", [(5, 2), (40, 0), (40, 3), (200, 2)])
def test_fused_matches_plain(cuda_device, B, sweeps):
    a, w, w16, p, oh = _small_batch(7, B)
    before = dict(haplotag_kernel.LAUNCHES)
    got = haplotag_kernel.phase_and_tag_fused(a, w16, p, oh, sweeps)
    want = phase_and_tag(a, w, p, oh, sweeps)
    torch.cuda.synchronize()
    assert haplotag_kernel.LAUNCHES["haplotag_sweep"] == \
        before["haplotag_sweep"] + sweeps
    assert haplotag_kernel.LAUNCHES["haplotag_score_shared"] == \
        before["haplotag_score_shared"] + 1
    for key in ("hap", "pc", "best_block", "phase"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("B", [5, 200])
def test_score_pre_matches_plain(cuda_device, B):
    a, w, _, p, oh = _small_batch(8, B)
    before = haplotag_kernel.LAUNCHES["haplotag_score_pre"]
    got = haplotag_kernel.haplotag_score(a, w, p, oh)
    aw = a.to(torch.bfloat16) * w.to(torch.bfloat16)
    want = haplotag_score_plain(aw, aw.abs(), haplotag_kernel._rhs(p, oh), B)
    torch.cuda.synchronize()
    assert haplotag_kernel.LAUNCHES["haplotag_score_pre"] == before + 1
    for name, x, y in zip(("hap", "pc", "best"), got, want):
        assert torch.equal(x, y), name


def test_sparse_scorer_on_card_matches_cpu(cuda_device):
    """The sparse COO scorer's torch ops (int32 index_add_, scatter
    min/max, first-max argmax) on the card equal the same ops on the CPU,
    on reads spanning up to ~40 blocks (overflow) and entry-less reads."""
    from duet_tpu_torch.models.snp_phaser_host import AlleleMatrix
    from duet_tpu_torch.ops.sparse_power import haplotag_score_sparse

    rng = np.random.default_rng(4)
    n_reads, n_sites, nnz = 3000, 5000, 60000
    key = np.unique(rng.integers(5, n_reads, nnz) * n_sites +
                    rng.integers(0, n_sites, nnz))
    am = AlleleMatrix(n_reads, n_sites, np.arange(n_sites) * 100,
                      (key // n_sites).astype(np.int32),
                      (key % n_sites).astype(np.int32),
                      rng.choice(np.array([-1, 1], np.int8), len(key)),
                      rng.integers(1, 41, len(key)).astype(np.float32))
    phase = rng.choice(np.array([-1, 0, 1], np.int8), n_sites)
    block_id = np.sort(rng.integers(0, 200, n_sites))
    got = haplotag_score_sparse(am, phase, block_id, cuda_device)
    want = haplotag_score_sparse(am, phase, block_id, torch.device("cpu"))
    assert got[3].any() and (got[0][:5] == 0).all()
    for name, g, w in zip(("hap", "pc", "best", "overflow"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_device_routes_on_card_match_host(cuda_device, tmp_path):
    """Every device route on the card (pileup, clustering, refine, dense
    scoring, decision) writes the artifacts of the host-only run."""
    from duet_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from duet_tpu_torch.sim import SimConfig, simulate_dataset

    data = str(tmp_path / "data")
    simulate_dataset(data, SimConfig(contigs={"chr1": 150_000,
                                              "chr2": 100_000},
                                     seed=9, coverage=15.0))
    outs = {}
    for mode in ("on", "off"):
        outs[mode] = str(tmp_path / mode)
        run_pipeline(PipelineConfig(bam=os.path.join(data, "reads.bam"),
                                    reference=os.path.join(data, "ref.fa"),
                                    output=outs[mode], device_stages=mode,
                                    device="cuda"))
    with open(os.path.join(outs["on"], "metrics.json")) as f:
        backends = json.load(f)["backends"]
    assert set(backends.values()) == {"device"}, backends
    for name in ("snp_calling/pileup.vcf.gz", "sv_calling/variants.vcf",
                 "phased_sv.vcf"):
        assert chip_smoke._read(os.path.join(outs["on"], name)) == \
            chip_smoke._read(os.path.join(outs["off"], name)), name


def test_nn_forward_on_card_matches_cpu(cuda_device):
    from duet_tpu_torch.models.nn_snp import N_FEATURES, load_model

    x = torch.from_numpy(
        np.random.default_rng(1).random((4096, N_FEATURES), np.float32))
    with torch.no_grad():
        gpu = load_model(device=cuda_device)(x.to(cuda_device)).cpu()
        cpu = load_model()(x)
    assert torch.equal(gpu.argmax(1), cpu.argmax(1))


def test_train_on_card(cuda_device, tmp_path, monkeypatch):
    """Five training steps on the card on a small corpus: the model's
    parameters live on the card, the loss is logged, and the saved .npz
    loads to the same classes on the card as on the CPU."""
    from duet_tpu_torch.models import nn_snp
    from duet_tpu_torch.models.nn_snp_host import build_training_set

    X, y = build_training_set(seeds=(11,), coverages=(8.0,),
                              error_rates=(0.02,), contig_len=60_000)
    monkeypatch.setattr(nn_snp, "build_training_set", lambda: (X, y))
    seen = []
    to_numpy = nn_snp.params_to_numpy

    def record(model):
        seen.extend(p.device for p in model.parameters())
        return to_numpy(model)

    monkeypatch.setattr(nn_snp, "params_to_numpy", record)
    logs = []
    out = str(tmp_path / "w.npz")
    nn_snp.train(out, steps=5, device=cuda_device, log=logs.append)
    assert len(seen) == 6 and all(d.type == "cuda" for d in seen)
    assert [m.split(":")[0] for m in logs if m.startswith("step ")] == \
        ["step 0", "step 4"]
    x = torch.from_numpy(X)
    with torch.no_grad():
        gpu = nn_snp.load_model(out, cuda_device)(x.to(cuda_device)).cpu()
        cpu = nn_snp.load_model(out)(x)
    assert torch.equal(gpu.argmax(1), cpu.argmax(1))


@pytest.mark.parametrize("case", [*chip_smoke.SNP_FEATURE_EDGE_CASES,
                                  "cell_shape"])
def test_snp_feature_kernels_match_twins(cuda_device, case):
    """The candidate and feature kernels on the card against their twins
    on the CPU: the four candidate fields and the features' bytes, on the
    edge cases in chunks of 7 and on a counts image shaped like the
    q10-10x cell (6 M positions at 10x, 10% error) in nn_call_snps'
    chunks; each kernel launched."""
    from duet_tpu_torch.ops import snp_features

    if case == "cell_shape":
        counts, ref = chip_smoke.snp_feature_counts(
            chip_smoke.SNP_CELL_POSITIONS, 5)
        batch = 65536
    else:
        counts, ref = chip_smoke.snp_feature_edge_inputs(case)
        batch = 7
    snp_features.reset_launches()
    n = chip_smoke.check_snp_features(counts, ref, batch, case)
    launched = dict(snp_features.LAUNCHES)
    assert launched["cand_count"] == 1
    assert launched["cand_compact"] == (1 if n else 0)
    assert launched["cand_features"] == -(-n // batch)
    if case == "cell_shape":
        assert n > len(ref) // 10


def test_nn_call_snps_on_card_matches_cpu(cuda_device, tmp_path):
    """nn_call_snps on the card (candidates and features by the kernels)
    against the CPU's numpy route on a simulated contig, field for field;
    the kernels launched and the candidates counted."""
    from duet_tpu_torch.io.fasta import FastaFile
    from duet_tpu_torch.io.readstore import load_read_store
    from duet_tpu_torch.models.nn_snp import nn_call_snps
    from duet_tpu_torch.models.snp_caller_host import (
        SnpCallConfig, count_alleles, pileup_observations)
    from duet_tpu_torch.ops import snp_features
    from duet_tpu_torch.sim import SimConfig, simulate_dataset
    from duet_tpu_torch.utils import dispatch, spans

    data = str(tmp_path / "data")
    simulate_dataset(data, SimConfig(contigs={"chr1": 400_000}, seed=13,
                                     coverage=10.0))
    cr = load_read_store(os.path.join(data, "reads.bam")).contigs["chr1"]
    codes = FastaFile(os.path.join(data, "ref.fa")).fetch_codes("chr1")
    cfg = SnpCallConfig()
    obs = pileup_observations(cr, cfg)
    counts = count_alleles(obs[0], obs[1], obs[2], len(codes),
                           cfg.min_base_qual)
    for c in (counts, counts.astype(np.int32)):
        spans.reset()
        snp_features.reset_launches()
        got = nn_call_snps("chr1", c, codes, device=cuda_device, batch=5000)
        n = spans.snapshot()["counters"]["snp_calling.candidates"]
        assert dispatch.snapshot()["snp_features"] == {"kernel": 1}
        assert snp_features.LAUNCHES == {"cand_count": 1, "cand_compact": 1,
                                         "cand_features": -(-n // 5000)}
        want = nn_call_snps("chr1", c, codes, batch=5000)
        assert len(got.pos) > 0 and n > len(got.pos)
        for f in ("pos", "ref_code", "alt_code", "is_het", "depth",
                  "alt_count"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
            assert getattr(got, f).dtype == getattr(want, f).dtype, f
