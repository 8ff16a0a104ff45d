"""Device pileup of the torch port against the JAX kernel and the host
caller: the histogram with its sentinel bin, site calling, the packed
expand/count/compact kernel, and the SNP stage's device glue (windowed,
grouped, overflow recount).  Exact equality."""

import numpy as np
import pytest
import torch

import chip_smoke

from duet_tpu.models import snp_caller as jsc
from duet_tpu.models.snp_caller import SnpCallConfig, call_snps, count_alleles
from duet_tpu.ops import pileup as jp
from duet_tpu_torch.utils import dispatch
from duet_tpu_torch.models import snp_caller as tsc
from duet_tpu_torch.ops import pileup as tp
from duet_tpu_torch.ops import pileup_kernel as pk
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


@pytest.mark.parametrize("seed,max_sites", [(2, 256), (3, 512), (4, 8)] + [
    (case, None) for case in chip_smoke.PILEUP_EDGE_CASES])
def test_packed_kernel_matches_jax(seed, max_sites):
    """Including a compaction smaller than the site count (max_sites 8):
    n_sites reports the true count, the first sites are kept; and on the
    hand kernels' edge cases (chip_smoke.PILEUP_EDGE_CASES), where the
    whole flat output is compared, the slots past the sites included."""
    if isinstance(seed, str):
        ops4, payload, total, Lw, max_sites = \
            chip_smoke.pileup_edge_inputs(seed)
    else:
        ops4, payload, total, Lw = packed_inputs(seed)
    want = np.asarray(jp.pileup_call_packed(ops4, payload, total=total,
                                            length=Lw, max_sites=max_sites))
    got = tp.pileup_call_packed(torch.from_numpy(ops4),
                                torch.from_numpy(payload), total=total,
                                length=Lw, max_sites=max_sites)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] > 0


@pytest.mark.parametrize("case", chip_smoke.PILEUP_EDGE_CASES)
def test_packed_edge_cases_at_scale_match_jax(case):
    """The edge cases at 40 times the ops and positions, the size at which
    the card's kernels spread them over several CTAs: the whole flat
    output equals duet_tpu's kernel."""
    ops4, payload, total, L, max_sites = chip_smoke.pileup_edge_inputs(
        case, 40)
    want = np.asarray(jp.pileup_call_packed(ops4, payload, total=total,
                                            length=L, max_sites=max_sites))
    got = tp.pileup_call_packed(torch.from_numpy(ops4),
                                torch.from_numpy(payload), total=total,
                                length=L, max_sites=max_sites)
    np.testing.assert_array_equal(got.numpy(), want)


def _edge_window(case):
    ops4, payload, total, L, max_sites = chip_smoke.pileup_edge_inputs(case)
    return (torch.from_numpy(ops4), torch.from_numpy(payload), total, L,
            max_sites)


@pytest.mark.parametrize("case", chip_smoke.PILEUP_EDGE_CASES)
def test_pileup_edge_cases_reach_their_edges(case):
    """Each edge case holds what it is named for, and the sentinel bin of
    the plain count is every lane that did not count (the kernel builds it
    as total minus the kept lanes)."""
    ops4, payload, total, L, max_sites = _edge_window(case)
    bins = tp.count_plain(ops4, payload, total=total, length=L)
    counts = bins[:4 * L].reshape(L, 4)
    assert int(bins[-1]) == total - int(counts.sum())
    nb = payload.shape[0] - L
    ref = payload[nb:].long()
    out = tp.packed_window_body(ops4, payload, total=total, length=L,
                                max_sites=max_sites)
    n_sites = int(out[0])
    ln, n_real = ops4[2], int(ops4[3, 0])
    tail = int(torch.nonzero(ln)[-1])               # the pad lanes' op
    assert int(ln.sum()) == total and n_sites > 0
    if case == "zero_len_pad":
        assert int(ln[0]) == 0 and (ln[:tail] == 0).sum() > 1
        assert n_real < int(ln[:tail].sum())        # real lanes masked too
        assert n_sites < max_sites                  # slots past the sites
    elif case == "odd_past_length":
        assert ((ops4[0] + ln)[:tail] > L).any() and (ops4[0] > L).any()
        assert int((ops4[1] + ln)[:tail].max()) % 2 == 1
    elif case == "n_qual_fail":
        nib = torch.stack([payload[:nb] & 15, payload[:nb] >> 4], 1).flatten()
        assert ((nib & 7) >= 4).any() and ((nib & 8) == 0).any()
    elif case == "ref4_depth0":
        assert (ref == 4).any() and (counts.sum(1) == 0).any()
    elif case == "ties":
        nonref = counts.clone()
        nonref[torch.arange(L), ref.clamp(max=3)] = -1
        top = nonref.max(1).values
        assert (((nonref == top[:, None]).sum(1) > 1) & (top > 0)).any()
    elif case == "overflow":
        assert n_sites > max_sites == 8
    elif case == "one_position":
        assert L == 1 and ((ops4[0] + ln)[:tail] > 1).any()
    elif case == "negative_query":
        q = ops4[1][:tail].long()
        assert ((q < 0) & (q >= -2 * nb)).any()     # counts from the end
        assert ((q < 0) & (q + ln[:tail] > 0)).any()  # crosses nibble 0
        assert (q < -2 * nb).any()                  # clamped after the wrap
    elif case == "tile_seams":
        start, end = ops4[0][:tail].long(), (ops4[0] + ln)[:tail].long()
        assert L >= 8 * 8192 and L % 1024 > 0
        assert ((start + 3) % 1024 <= 3).all()
        assert ((end - 1) // 1024 > start // 1024).any()
        assert ((end - 1) // 1024 - start // 1024 >= 3).any()
        per_seam = torch.bincount((start + 3) // 1024)
        assert per_seam.max() >= 10 * per_seam[per_seam > 0].median()
    else:
        assert case == "wrapped_keys"
        r = ops4[0][:tail].long()
        assert (r < 0).any() and (r >= 2**31 - 21).any()
        assert ((r >= 2**30 - 20) & (r < 2**30)).any()
        # keys past [0, 4L) before the int32 wrap: into it after, and not
        n = ln[:tail].long()
        op = torch.repeat_interleave(torch.arange(tail), n)
        within = torch.arange(len(op)) - torch.repeat_interleave(
            torch.cumsum(n, 0) - n, n)
        key = (r[op] + within) * 4
        wrapped = (key + 2**31) % 2**32 - 2**31
        off = (key < 0) | (key >= 4 * L)
        inside = (wrapped >= 0) & (wrapped < 4 * L)
        assert (off & inside).any() and (off & ~inside).any()
    # the ops off the count kernel's tiles: none in the packers' layout
    assert (pk.second_path_ops(ops4, payload, total=total, length=L) > 0) == (
        case in ("odd_past_length", "one_position", "negative_query",
                 "wrapped_keys"))


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_packed_windows_keep_every_op_on_the_tiles(seed):
    """A window as _device_window packs it has no op off the count
    kernel's tiles."""
    ops4, payload, total, Lw = packed_inputs(seed)
    assert pk.second_path_ops(torch.from_numpy(ops4),
                              torch.from_numpy(payload), total=total,
                              length=Lw) == 0


def test_cpu_wrappers_run_the_plain_version_and_count_nothing():
    """On CPU tensors the kernel wrappers and packed_window_body run the
    plain versions and count no launch."""
    ops4, payload, total, L, max_sites = _edge_window("overflow")
    pk.reset_launches()
    nb = payload.shape[0] - L
    want_bins = tp.count_plain(ops4, payload, total=total, length=L)
    want = tp.call_plain(want_bins, payload[nb:], ops4[3], max_sites)
    bins = pk.pileup_count(ops4, payload, total=total, length=L)
    assert torch.equal(bins, want_bins)
    assert torch.equal(pk.pileup_call(bins, payload[nb:], ops4[3],
                                      max_sites), want)
    assert torch.equal(tp.packed_window_body(ops4, payload, total=total,
                                             length=L, max_sites=max_sites),
                       want)
    with pytest.raises(ValueError, match="CUDA"):
        pk.pileup_count_report(ops4, payload, total=total, length=L)
    assert pk.LAUNCHES == {"pileup_count": 0, "pileup_call": 0}


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a wrapper sees of a
    card tensor, on a host without one."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_raises_when_the_library_fails(monkeypatch):
    """A CUDA tensor goes to the kernels: when the library cannot be built
    the call raises, and neither falls back to the plain version nor
    counts a launch."""
    def no_library():
        raise RuntimeError("nvcc not found")

    def no_plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(pk, "_library", no_library)
    monkeypatch.setattr(pk, "count_plain", no_plain)
    monkeypatch.setattr(pk, "call_plain", no_plain)
    ops4, payload, total, L, max_sites = _edge_window("ties")
    ops4 = torch.Tensor._make_subclass(_CudaTyped, ops4)
    payload = torch.Tensor._make_subclass(_CudaTyped, payload)
    assert ops4.device.type == "cuda"
    pk.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tp.packed_window_body(ops4, payload, total=total, length=L,
                              max_sites=max_sites)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pk.pileup_count(ops4, payload, total=total, length=L)
    assert pk.LAUNCHES == {"pileup_count": 0, "pileup_call": 0}


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
