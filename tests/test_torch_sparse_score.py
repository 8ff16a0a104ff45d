"""The port's sparse COO read scorer and the batched scoring of many contigs
against the JAX package: ``haplotag_score_sparse`` / ``_multi`` on fuzzed
COO matrices, ``score_contigs_batched`` under both scorer modes, and the
combined-nnz device gate.  Exact equality throughout."""

import json
import os

import numpy as np
import pytest
import torch

from duet_tpu.models import snp_phaser as sp
from duet_tpu.ops import sparse_power as jax_sparse
from duet_tpu.pipeline import PipelineConfig as JaxConfig
from duet_tpu.pipeline import run_pipeline as jax_run
from duet_tpu.utils import dispatch as jax_dispatch
from duet_tpu_torch.models import snp_phaser as tsp
from duet_tpu_torch.ops import sparse_power
from duet_tpu_torch.pipeline import PipelineConfig, run_pipeline
from duet_tpu_torch.utils import dispatch
from test_snp_phaser import diploid_matrix, matrix_from_dense
from test_torch_pipeline import _artifacts, _read

CPU = torch.device("cpu")


def fuzz_case(seed, n_reads, n_sites, nnz, n_blocks=12, empty_reads=3):
    """A random COO whose phase-set blocks are intervals of the site axis:
    some sites unobserved (block -1), `empty_reads` reads with no entry,
    zero-phase sites, and reads whose entries span many blocks (more than
    SLOT_K when n_blocks allows it)."""
    rng = np.random.default_rng(seed)
    observed = rng.random(n_sites) < 0.85
    observed[0] = True
    sites = np.flatnonzero(observed)
    readers = np.arange(empty_reads, n_reads)
    row = np.sort(rng.choice(readers, nnz))
    col = rng.choice(sites, nnz)
    # one (row, col) pair per entry, as build_allele_matrix gives
    key = np.unique(row.astype(np.int64) * n_sites + col)
    row = (key // n_sites).astype(np.int32)
    col = (key % n_sites).astype(np.int32)
    block_id = np.full(n_sites, -1, np.int64)
    block_id[sites] = np.sort(rng.integers(0, n_blocks, len(sites)))
    # renumber to 0..k-1 so every block id in the table is used
    used, block_id[sites] = np.unique(block_id[sites], return_inverse=True)
    am = sp.AlleleMatrix(
        n_reads=n_reads, n_sites=n_sites,
        site_pos=np.arange(n_sites, dtype=np.int64) * 100 + 7,
        row=row, col=col,
        allele=rng.choice(np.array([-1, 1], np.int8), len(row)),
        weight=rng.integers(1, 41, len(row)).astype(np.float32))
    phase = rng.choice(np.array([-1, 0, 1], np.int8), n_sites,
                       p=[0.45, 0.1, 0.45])
    block_ps = np.arange(len(used), dtype=np.int64) * 100 + 7
    return am, phase, block_id, block_ps


def _assert_scored_equal(got, want):
    for name, g, w in zip(("hap", "pc", "best", "overflow"), got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("seed,n_reads,n_sites,nnz", [
    (0, 8, 8, 40),          # every size at the power-of-two floor
    (1, 9, 17, 65),         # just past it
    (2, 64, 128, 256),      # at a power of two
    (3, 65, 129, 257),      # just past one
    (4, 300, 900, 6000),    # long reads over many blocks: overflow
])
def test_score_sparse_matches_jax(seed, n_reads, n_sites, nnz):
    am, phase, block_id, _ = fuzz_case(seed, n_reads, n_sites, nnz,
                                       n_blocks=max(n_sites // 6, 2))
    got = sparse_power.haplotag_score_sparse(am, phase, block_id, CPU)
    want = jax_sparse.haplotag_score_sparse(am, phase, block_id)
    _assert_scored_equal(got, want)
    assert (got[0][:3] == 0).all()          # entry-less reads untagged
    if seed == 4:
        assert got[3].any() and not got[3].all()


def test_score_sparse_multi_matches_jax():
    """Several contigs in one launch, with read, site and block offsets;
    one contig has no entry at all."""
    items = [fuzz_case(10 + k, n, m, z)[:3] for k, (n, m, z) in
             enumerate([(40, 60, 300), (9, 17, 65), (70, 200, 900)])]
    empty = fuzz_case(20, 5, 10, 1)[:3]
    empty = (sp.AlleleMatrix(5, 10, empty[0].site_pos,
                             *(a[:0] for a in (empty[0].row, empty[0].col,
                                               empty[0].allele,
                                               empty[0].weight))),
             empty[1], empty[2])
    items.insert(1, empty)
    got = sparse_power.haplotag_score_sparse_multi(items, CPU)
    want = jax_sparse.haplotag_score_sparse_multi(items)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _assert_scored_equal(g, w)


@pytest.mark.parametrize("multi", [False, True])
def test_score_sparse_rejects_unblocked_observed_site(multi):
    """block_id[col] >= 0 is the scorer's invariant: a -1 block at an
    observed site raises instead of scoring garbage."""
    am, phase, block_id, _ = fuzz_case(5, 30, 40, 200)
    block_id = block_id.copy()
    block_id[am.col[0]] = -1
    with pytest.raises(ValueError, match="block -1"):
        if multi:
            sparse_power.haplotag_score_sparse_multi(
                [(am, phase, block_id)], CPU)
        else:
            sparse_power.haplotag_score_sparse(am, phase, block_id, CPU)


def diploid_core(seed, n_reads, n_sites, span=12, err=0.05):
    """(am, phase, block_id, block_ps) of one refined simulated contig."""
    rng = np.random.default_rng(seed)
    D, _ = diploid_matrix(rng, n_reads=n_reads, n_sites=n_sites, span=span,
                          err=err)
    am = matrix_from_dense(D)
    phase, block_id, block_ps = sp._initial_phase(am)
    phase = sp._power_refine(am, phase, block_id, sweeps=2)
    return am, phase, block_id, block_ps


def _cores():
    return {"chrA": diploid_core(1, 150, 90), "chrB": diploid_core(2, 220, 70),
            "chrC": fuzz_case(3, 120, 400, 2500, n_blocks=60)}


@pytest.mark.parametrize("seed", [1, 2])
def test_haplotag_device_sparse_mode_matches_host_and_jax(seed):
    """`_haplotag_device(mode="sparse")`: the single-contig sparse route,
    host fallback for reads over SLOT_K blocks included."""
    core = fuzz_case(seed, 120, 400, 2500, n_blocks=60) if seed == 2 \
        else diploid_core(seed, 150, 90)
    got = tsp._haplotag_device(*core, mode="sparse", device=CPU)
    for want in (sp._haplotag(*core), sp._haplotag_sparse_device(*core)):
        for g, w, name in zip(got, want, ("hap", "ps", "pc")):
            np.testing.assert_array_equal(g, w, err_msg=name)


RESULT_KEYS = ("site_pos", "phase", "block_id", "block_ps", "read_hap",
               "read_ps", "read_pc")


@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("use_device", [True, False])
def test_score_contigs_batched_matches_jax(monkeypatch, mode, use_device):
    monkeypatch.setattr(tsp, "HAPLOTAG_DEVICE_MODE", mode)
    cores = _cores()
    want = sp.score_contigs_batched(cores, use_device, 0)
    got = tsp.score_contigs_batched(cores, use_device, 0, CPU)
    assert list(got) == list(cores)
    for c in cores:
        for key in RESULT_KEYS:
            np.testing.assert_array_equal(getattr(got[c], key),
                                          getattr(want[c], key),
                                          err_msg=f"{c} {key}")


def _haplotag_on_device(fn, registry) -> bool:
    """Whether `fn` scored on the device, read from the dispatch registry
    of the package that ran it."""
    registry.reset()
    fn()
    return registry.snapshot().get("haplotag", {}).get("device", 0) > 0


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_device_gate_reads_the_combined_nnz(monkeypatch, mode):
    """Two contigs, each under the gate, whose sum clears it: the batch is
    scored on the device exactly when duet_tpu's score_contigs_batched
    scores it there."""
    monkeypatch.setattr(tsp, "HAPLOTAG_DEVICE_MODE", mode)
    cores = {"chrA": diploid_core(1, 150, 90), "chrB": diploid_core(2, 220,
                                                                     70)}
    nnz = [len(core[0].row) for core in cores.values()]
    for gate, on_device in [(max(nnz) + 1, True), (sum(nnz), True),
                            (sum(nnz) + 1, False)]:
        jax_dev = _haplotag_on_device(
            lambda: sp.score_contigs_batched(cores, True, gate), jax_dispatch)
        port_dev = _haplotag_on_device(
            lambda: tsp.score_contigs_batched(cores, True, gate, CPU),
            dispatch)
        assert jax_dev == port_dev == on_device, gate


def test_pipeline_sparse_mode_matches_jax(sim_dataset, tmp_path,
                                          monkeypatch):
    """The port's pipeline with the sparse scorer (duet_tpu's default
    route, and auto's on the card) writes duet_tpu's --device-stages on
    artifacts: auto with every gate open, its device routes on the CPU.
    Under on, which forces the hand kernel's dense route, the scorer is
    dense whatever HAPLOTAG_DEVICE_MODE says."""
    monkeypatch.setattr(tsp, "HAPLOTAG_DEVICE_MODE", "sparse")
    for gate in ("SV_GATE_H100_K", "PHASING_GATE_H100_NNZ",
                 "DECIDE_GATE_H100_CALLS"):
        monkeypatch.setattr(PipelineConfig, gate, 0)
    monkeypatch.setattr(PipelineConfig, "stages_on_device",
                        lambda self: self.device_stages != "off")
    data, _, _ = sim_dataset
    paths = dict(bam=os.path.join(data, "reads.bam"),
                 reference=os.path.join(data, "ref.fa"))
    want, got = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_run(JaxConfig(output=want, device_stages="on", snp_model="counts",
                      **paths))
    cfg = PipelineConfig(output=got, device_stages="auto", device="cpu",
                         snp_model="counts", **paths)
    assert cfg.haplotag_mode() == "sparse"
    assert PipelineConfig(output=got, device_stages="on", device="cpu",
                          **paths).haplotag_mode() == "dense"
    run_pipeline(cfg)
    assert _artifacts(got) == _artifacts(want)
    for name in _artifacts(want):
        assert _read(os.path.join(got, name)) == \
            _read(os.path.join(want, name)), name
    with open(os.path.join(got, "metrics.json")) as f:
        metrics = json.load(f)
    assert metrics["device_dispatch"]["haplotag"]["device"] == 1
    # every gated stage on the device; auto keeps the pileup on the host,
    # and the BGZF inflate's card route runs on CUDA only
    assert {s: b for s, b in metrics["backends"].items()
            if b != "device"} == {"snp_pileup": "host",
                                  "ingest_inflate": "host"}
