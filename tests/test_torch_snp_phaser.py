"""SNP-phasing device glue of the torch port against the JAX package: the
dense windowed scorer against duet_tpu's host scorer ``_haplotag`` (on the
cases of tests/test_haplotag_device_path.py), and the refine sweeps against
duet_tpu's ``power_refine_device``.  Exact equality throughout."""

import numpy as np
import pytest
import torch

from duet_tpu.models import snp_phaser as sp
from duet_tpu.ops.sparse_power import power_refine_device as jax_refine
from duet_tpu_torch.utils import dispatch
from duet_tpu_torch.models import snp_phaser as tsp
from duet_tpu_torch.ops import haplotag_kernel
from duet_tpu_torch.ops.sparse_power import power_refine_device
from test_snp_phaser import diploid_matrix, matrix_from_dense

CPU = torch.device("cpu")


def refined_case(seed, n_reads, n_sites, span, err):
    rng = np.random.default_rng(seed)
    D, _ = diploid_matrix(rng, n_reads=n_reads, n_sites=n_sites, span=span,
                          err=err)
    am = matrix_from_dense(D)
    phase, block_id, block_ps = sp._initial_phase(am)
    phase = sp._power_refine(am, phase, block_id, sweeps=2)
    return am, phase, block_id, block_ps


@pytest.mark.parametrize("seed,window,halo,batch", [
    (0, 32, 8, 16),     # many windows, reads span window edges -> halo
    (1, 2048, 256, 16),  # one window
    (2, 32, 8, 2),      # batch smaller than the task count -> several launches
    (3, 64, 16, 1),     # one chunk per launch
])
def test_dense_device_scoring_matches_host(seed, window, halo, batch):
    am, phase, block_id, block_ps = refined_case(seed, 150, 90, 12, 0.05)
    host = sp._haplotag(am, phase, block_id, block_ps)
    got = tsp._haplotag_device(am, phase, block_id, block_ps, window=window,
                               halo=halo, batch=batch, mode="dense",
                               device=CPU)
    for h, d, name in zip(host, got, ("hap", "ps", "pc")):
        np.testing.assert_array_equal(d, h, err_msg=name)


def test_dense_scoring_with_phase_set_splits():
    """Several phase-set blocks inside one window (split by hand, as weak-
    junction splitting does), so reads straddle blocks and the best-block
    choice matters."""
    am, phase, _, _ = refined_case(5, 250, 120, 9, 0.05)
    block_id = (np.arange(am.n_sites) // 25).astype(np.int32)
    block_ps = am.site_pos[::25] + 1
    host = sp._haplotag(am, phase, block_id, block_ps)
    assert len(np.unique(host[1][host[1] >= 0])) == len(block_ps)
    got = tsp._haplotag_device(am, phase, block_id, block_ps, mode="dense",
                               device=CPU)
    for h, d, name in zip(host, got, ("hap", "ps", "pc")):
        np.testing.assert_array_equal(d, h, err_msg=name)


def test_batched_dispatch_call_count():
    """A contig's chunks ride ceil(chunks / batch) launches, not one per
    chunk; on the CPU no kernel launches."""
    rng = np.random.default_rng(11)
    D, _ = diploid_matrix(rng, n_reads=900, n_sites=120, span=10, err=0.05)
    am = matrix_from_dense(D)
    phase, block_id, block_ps = sp._initial_phase(am)
    dispatch.reset()
    before = dict(haplotag_kernel.LAUNCHES)
    tsp._haplotag_device(am, phase, block_id, block_ps, window=16, halo=4,
                         batch=16, mode="dense", device=CPU)
    # 900 reads over ~8 windows -> >= 8 chunks in one launch; reads wider
    # than the halo take the host scorer
    assert dispatch.snapshot()["haplotag"]["device"] == 1
    assert haplotag_kernel.LAUNCHES == before


def test_overfull_window_falls_back_to_host():
    """More phase-set blocks in a window than the kernel's block axis:
    the window's reads take the host scorer and outputs stay equal."""
    n_pairs = sp.HAPLOTAG_B + 10
    rows, cols, alleles, weights = [], [], [], []
    for i in range(n_pairs):  # read i covers only sites (2i, 2i+1)
        rows += [i, i]
        cols += [2 * i, 2 * i + 1]
        alleles += [1, -1]
        weights += [30.0, 30.0]
    am = sp.AlleleMatrix(
        n_reads=n_pairs, n_sites=2 * n_pairs,
        site_pos=np.arange(2 * n_pairs, dtype=np.int64) * 100,
        row=np.array(rows, np.int32), col=np.array(cols, np.int32),
        allele=np.array(alleles, np.int8),
        weight=np.array(weights, np.float32))
    phase, block_id, block_ps = sp._initial_phase(am)
    assert len(block_ps) > sp.HAPLOTAG_B
    host = sp._haplotag(am, phase, block_id, block_ps)
    dispatch.reset()
    got = tsp._haplotag_device(am, phase, block_id, block_ps, window=4096,
                               halo=256, mode="dense", device=CPU)
    assert dispatch.snapshot()["haplotag"].get("host", 0) == 1
    for h, d, name in zip(host, got, ("hap", "ps", "pc")):
        np.testing.assert_array_equal(d, h, err_msg=name)


@pytest.mark.parametrize("seed,err,sweeps", [(7, 0.08, 3), (8, 0.0, 2),
                                             (9, 0.2, 1)])
def test_power_refine_matches_jax(seed, err, sweeps):
    rng = np.random.default_rng(seed)
    D, _ = diploid_matrix(rng, n_reads=200, n_sites=77, span=14, err=err)
    am = matrix_from_dense(D)
    phase0, block_id, _ = sp._initial_phase(am)
    want = jax_refine(am, phase0.copy(), block_id, sweeps=sweeps)
    host = sp._power_refine(am, phase0.copy(), block_id, sweeps=sweeps)
    got = power_refine_device(am, phase0.copy(), block_id, sweeps=sweeps,
                              device=CPU)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, host)


def test_phase_contig_matches_jax(sim_dataset):
    """Refine + dense scoring of a simulated contig equal duet_tpu's
    phase_contig."""
    from duet_tpu.io.fasta import FastaFile
    from duet_tpu.io.readstore import load_read_store
    from duet_tpu.models.snp_caller import call_snps_for_store

    out, _, _ = sim_dataset
    store = load_read_store(f"{out}/reads.bam")
    fa = FastaFile(f"{out}/ref.fa")
    snps, _ = call_snps_for_store(store, {"chr21": fa.fetch_codes("chr21")})
    cr = store.contigs["chr21"]
    want = sp.phase_contig(cr, snps["chr21"], use_device=True)
    dispatch.reset()
    core = tsp.phase_contig_core(cr, snps["chr21"], use_device=True,
                                 device=CPU)
    got = tsp.score_contigs_batched({"chr21": core}, use_device=True,
                                    device_min_nnz=0, device=CPU)["chr21"]
    snap = dispatch.snapshot()
    assert snap["haplotag"] == {"device": 1}
    assert set(snap["phase_refine"]) == {"device"}
    for key in ("phase", "block_id", "block_ps", "read_hap", "read_ps",
                "read_pc"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key),
                                      err_msg=key)
    assert got.row_names == want.row_names
