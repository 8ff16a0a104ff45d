"""Device pileup of the torch port against the JAX kernel and the host
caller: the histogram with its sentinel bin, site calling, the packed
expand/count/compact kernel, and the SNP stage's device glue (windowed,
grouped, overflow recount).  Exact equality."""

import numpy as np
import pytest
import torch

from duet_tpu.models import snp_caller as jsc
from duet_tpu.models.snp_caller import SnpCallConfig, call_snps, count_alleles
from duet_tpu.ops import pileup as jp
from duet_tpu_torch.utils import dispatch
from duet_tpu_torch.models import snp_caller as tsc
from duet_tpu_torch.ops import pileup as tp
from test_pileup_kernel import random_observations, reads_from_observations

CPU = torch.device("cpu")
FIELDS = ("pos", "ref_code", "alt_code", "is_het", "depth", "alt_count")


def assert_snps_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f


def test_hist_counts_matches_jax_with_bad_keys():
    rng = np.random.default_rng(0)
    L = 300
    key = rng.integers(-50, 4 * L + 60, 20_000).astype(np.int32)
    want = np.asarray(jp._hist_counts(key, L))
    got = tp._hist_counts(torch.from_numpy(key), L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_call_sites_matches_jax():
    rng = np.random.default_rng(1)
    L = 800
    positions, bases, quals = random_observations(rng, L, 30_000)
    ref_codes = rng.integers(0, 5, L).astype(np.uint8)
    counts = count_alleles(positions.astype(np.int64), bases, quals, L, 10)
    params = (4, 1, 4, 3, 4, 3)
    want = jp.call_sites(np.asarray(counts, np.int32), ref_codes, *params)
    got = tp.call_sites(torch.from_numpy(np.asarray(counts, np.int32)),
                        torch.from_numpy(ref_codes), *params)
    for g, w, name in zip(got, want, ("is_site", "is_het", "alt_code",
                                      "depth", "alt_count")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def packed_inputs(seed, L=2000, n=40_000):
    """A window's (ops4, payload) as _device_window builds it."""
    rng = np.random.default_rng(seed)
    cfg = SnpCallConfig()
    positions, bases, quals = random_observations(rng, L, n)
    cr = reads_from_observations(positions, bases, quals)
    ref_codes = rng.integers(0, 4, L).astype(np.uint8)
    rw, q0, ln, _ = jsc.match_op_table(cr, cfg.min_mapq)
    packed = jsc._pack_codes(cr.seq, cr.qual, cfg.min_base_qual)
    total = int(ln.sum())
    total_pad = jsc._pow2(total)
    ops4 = np.zeros((4, max(jsc._pow2(len(ln) + 1), 1 << 12)), np.int32)
    ops4[0, :len(ln)], ops4[1, :len(ln)], ops4[2, :len(ln)] = rw, q0, ln
    ops4[2, len(ln)] = total_pad - total
    ops4[3, :8] = (total, 0, cfg.min_depth, 1, 4, 3, 4, cfg.min_alt_reads)
    ns_pad = max(jsc._pow2(len(packed)), total_pad, 2)
    Lw = jsc._pow2(L)
    payload = np.zeros(ns_pad // 2 + Lw, np.uint8)
    jsc._nibble_pack(packed, payload)
    payload[ns_pad // 2:] = 4
    payload[ns_pad // 2: ns_pad // 2 + L] = ref_codes
    return ops4, payload, total_pad, Lw


@pytest.mark.parametrize("seed,max_sites", [(2, 256), (3, 512), (4, 8)])
def test_packed_kernel_matches_jax(seed, max_sites):
    """Including a compaction smaller than the site count (max_sites 8):
    n_sites reports the true count, the first sites are kept."""
    ops4, payload, total, Lw = packed_inputs(seed)
    want = np.asarray(jp.pileup_call_packed(ops4, payload, total=total,
                                            length=Lw, max_sites=max_sites))
    got = tp.pileup_call_packed(torch.from_numpy(ops4),
                                torch.from_numpy(payload), total=total,
                                length=Lw, max_sites=max_sites)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] > 0


def test_device_window_overflow_recounts_on_host(monkeypatch):
    rng = np.random.default_rng(5)
    L = 3000
    cfg = SnpCallConfig()
    positions, bases, quals = random_observations(rng, L, 60_000)
    ref_codes = rng.integers(0, 4, L).astype(np.uint8)
    counts = count_alleles(positions.astype(np.int64), bases, quals, L,
                           cfg.min_base_qual)
    host = call_snps("c", counts, ref_codes, cfg)
    cr = reads_from_observations(positions, bases, quals)
    for window in (1024, 1 << 24):
        dispatch.reset()
        got = tsc.call_snps_device("c", cr, ref_codes, cfg, window=window,
                                   device=CPU)
        assert_snps_equal(got, host)
        assert dispatch.snapshot()["snp_pileup"].get("device", 0) >= 1
    # a window denser than the compaction capacity recounts on the host
    monkeypatch.setattr(tsc, "DEVICE_MAX_SITE_DENSITY", 1 << 20)
    dispatch.reset()
    got = tsc.call_snps_device("c", cr, ref_codes, cfg, device=CPU)
    assert dispatch.snapshot()["snp_pileup"] == {"device": 1, "host": 1}
    assert_snps_equal(got, host)


def test_store_device_paths_match_jax(sim_dataset, tmp_path):
    """call_snps_for_store on simulator reads, forced device: one contig
    (windowed path) and a store of three small contigs (grouped launch)."""
    from duet_tpu.io.fasta import FastaFile
    from duet_tpu.io.readstore import load_read_store
    from duet_tpu.sim import SimConfig, simulate_dataset

    cfg = SnpCallConfig(device=True)
    out, _, _ = sim_dataset
    multi = str(tmp_path / "multi")
    simulate_dataset(multi, SimConfig(
        contigs={"chr1": 30_000, "chr2": 25_000, "chr3": 20_000}, seed=4,
        coverage=10.0))
    for data in (out, multi):
        store = load_read_store(f"{data}/reads.bam")
        fa = FastaFile(f"{data}/ref.fa")
        codes = {c: fa.fetch_codes(c) for c in store.contigs}
        want, want_obs = jsc.call_snps_for_store(store, codes, cfg)
        dispatch.reset()
        got, got_obs = tsc.call_snps_for_store(store, codes, cfg, device=CPU)
        assert dispatch.snapshot()["snp_pileup"] == {"device": 1}
        assert list(got) == list(want)
        for c in want:
            assert_snps_equal(got[c], want[c])
            for a, b in zip(got_obs[c], want_obs[c]):
                np.testing.assert_array_equal(a, b)
