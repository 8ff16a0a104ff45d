"""The routes that ``--device-stages auto`` chooses between, against
duet_tpu on the CPU: the dense read scorer whose tiles are built on the
device, the device pileup whose payload is packed on the device and whose
at-site pass runs on the thread pool, ``route_crossover`` and
``stream_scale --device-stages``.  Exact equality throughout."""

import json
import os

import numpy as np
import pytest
import torch

from duet_tpu.io.fasta import FastaFile
from duet_tpu.io.readstore import load_read_store
from duet_tpu.models import snp_caller as jsc
from duet_tpu.models import snp_phaser as sp
from duet_tpu.sim import SimConfig, simulate_dataset
from duet_tpu_torch.models import snp_caller as tsc
from duet_tpu_torch.models import snp_phaser as tsp
from duet_tpu_torch.utils import dispatch
from test_snp_phaser import diploid_matrix, matrix_from_dense

CPU = torch.device("cpu")


def _refined(am):
    phase, block_id, block_ps = sp._initial_phase(am)
    return am, sp._power_refine(am, phase, block_id, 2), block_id, block_ps


def _past_halo():
    """Windows of 32 sites and a halo of 8: reads of 12 sites cross window
    edges, some past the halo (the host scorer takes those)."""
    rng = np.random.default_rng(0)
    D, _ = diploid_matrix(rng, n_reads=300, n_sites=200, span=12, err=0.05)
    return _refined(matrix_from_dense(D)), dict(window=32, halo=8)


def _overfull_window():
    """One window with more phase-set blocks than the kernel's block axis
    (reads of two sites each, a block per pair) beside windows that fit."""
    n_pairs = sp.HAPLOTAG_B + 10
    D = np.zeros((n_pairs + 200, 2 * n_pairs + 400), dtype=np.int8)
    for i in range(n_pairs):
        D[i, 2 * i], D[i, 2 * i + 1] = 1, -1
    rng = np.random.default_rng(1)
    D2, _ = diploid_matrix(rng, n_reads=200, n_sites=400, span=10, err=0.05)
    D[n_pairs:, 2 * n_pairs:] = D2
    return _refined(matrix_from_dense(D)), dict(window=2 * n_pairs + 16,
                                                halo=16)


def _empty_windows():
    """Reads only in windows 0 and 3 of five: windows 1, 2 and 4 hold no
    read, so they launch nothing."""
    rng = np.random.default_rng(2)
    D = np.zeros((160, 160), dtype=np.int8)
    D[:80, :32], _ = diploid_matrix(rng, n_reads=80, n_sites=32, span=8)
    D[80:, 96:128], _ = diploid_matrix(rng, n_reads=80, n_sites=32, span=8)
    return _refined(matrix_from_dense(D)), dict(window=32, halo=8)


def _chunks(n_reads):
    """`n_reads` reads of one window: n_reads / 256 chunks."""
    def case():
        rng = np.random.default_rng(n_reads)
        D, _ = diploid_matrix(rng, n_reads=n_reads, n_sites=60, span=6,
                              err=0.05)
        return _refined(matrix_from_dense(D)), {}
    return case


def _no_sites():
    am = sp.AlleleMatrix(n_reads=5, n_sites=0, site_pos=np.zeros(0, np.int64),
                         row=np.zeros(0, np.int32), col=np.zeros(0, np.int32),
                         allele=np.zeros(0, np.int8),
                         weight=np.zeros(0, np.float32))
    return _refined(am), {}


def _duplicate_cells():
    """A read observing one site twice (split alignments pooled in one
    row): the tile keeps the last observation, as duet_tpu's numpy tiles
    do."""
    (am, phase, block_id, block_ps), kw = _past_halo()
    k = np.arange(0, len(am.row), 7)
    dup = sp.AlleleMatrix(
        am.n_reads, am.n_sites, am.site_pos,
        np.concatenate([am.row, am.row[k]]),
        np.concatenate([am.col, am.col[k]]),
        np.concatenate([am.allele, -am.allele[k]]),
        np.concatenate([am.weight, am.weight[k] + 1]))
    return (dup, phase, block_id, block_ps), kw


DENSE_CASES = {
    "past_halo": _past_halo,
    "overfull_window": _overfull_window,
    "empty_windows": _empty_windows,
    # exactly HAPLOTAG_BATCH chunks fill one launch; one read more opens a
    # second
    "batch_exact": _chunks(sp.HAPLOTAG_BATCH * 256),
    "batch_exact_plus_one": _chunks(sp.HAPLOTAG_BATCH * 256 + 1),
    "no_sites": _no_sites,
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_route_built_on_device_matches_jax(case):
    """The port's dense route equals duet_tpu's dense route, and (but for
    a cell observed twice, where duet_tpu's tiles keep one observation)
    duet_tpu's host scorer."""
    (am, phase, block_id, block_ps), kw = DENSE_CASES[case]()
    want = sp._haplotag_device(am, phase, block_id, block_ps, mode="dense",
                               **kw)
    host = sp._haplotag(am, phase, block_id, block_ps)
    dispatch.reset()
    got = tsp._haplotag_device(am, phase, block_id, block_ps, mode="dense",
                               device=CPU, **kw)
    for g, w, h, name in zip(got, want, host, ("hap", "ps", "pc")):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(g, h, err_msg=f"{name} vs host")
    launches = dispatch.snapshot().get("haplotag", {}).get("device", 0)
    if case.startswith("batch_exact"):
        assert launches == (1 if case == "batch_exact" else 2)
    if case == "overfull_window":
        assert dispatch.snapshot()["haplotag"].get("host", 0) == 1


def test_dense_route_keeps_last_of_duplicate_cells():
    (am, phase, block_id, block_ps), kw = _duplicate_cells()
    want = sp._haplotag_device(am, phase, block_id, block_ps, mode="dense",
                               **kw)
    got = tsp._haplotag_device(am, phase, block_id, block_ps, mode="dense",
                               device=CPU, **kw)
    for g, w, name in zip(got, want, ("hap", "ps", "pc")):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Simulated stores of 1, 2 and 5 contigs (10x), with their codes."""
    out = {}
    for n in (1, 2, 5):
        d = str(tmp_path_factory.mktemp(f"contigs{n}"))
        simulate_dataset(d, SimConfig(
            contigs={f"c{i}": 24_000 + 4_000 * i for i in range(n)},
            coverage=10.0, seed=20 + n))
        fa = FastaFile(os.path.join(d, "ref.fa"))
        store = load_read_store(os.path.join(d, "reads.bam"))
        out[n] = (store, {c: fa.fetch_codes(c) for c in store.contigs})
    return out


def _assert_calls_equal(got, want):
    snps_g, obs_g = got
    snps_w, obs_w = want
    assert list(snps_g) == list(snps_w)
    for c in snps_w:
        for f in ("pos", "ref_code", "alt_code", "is_het", "depth",
                  "alt_count"):
            np.testing.assert_array_equal(getattr(snps_g[c], f),
                                          getattr(snps_w[c], f),
                                          err_msg=f"{c}.{f}")
        assert set(obs_g) == set(obs_w)
        for a, b in zip(obs_g[c], obs_w[c], strict=True):
            np.testing.assert_array_equal(a, b, err_msg=c)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("n_contigs", [1, 2, 5])
def test_device_pileup_matches_jax(stores, n_contigs, threads):
    """The device pileup (payload packed on the device, the at-site pass on
    the pool) gives duet_tpu's calls and at-site observations."""
    store, codes = stores[n_contigs]
    cfg = tsc.SnpCallConfig(device=True)
    want = jsc.call_snps_for_store(store, codes, cfg, threads=threads)
    dispatch.reset()
    got = tsc.call_snps_for_store(store, codes, cfg, threads=threads,
                                  device=CPU)
    assert dispatch.snapshot()["snp_pileup"] == {"device": 1}
    _assert_calls_equal(got, want)


def test_device_pileup_split_groups_match_jax(stores, monkeypatch):
    """A window small enough that the five contigs take several launches,
    some alone: the calls keep duet_tpu's launch order, and every at-site
    pass (started as its launch returns) equals duet_tpu's."""
    store, codes = stores[5]
    cfg = tsc.SnpCallConfig(device=True)
    window = 1 << 16
    items = [(c, store.contigs[c], codes[c]) for c in store.contigs]
    snps = jsc.call_snps_device_grouped(items, cfg, window=window)
    want = (snps, {c: jsc._at_site_obs(store.contigs[c], cfg, snps[c].pos)
                   for c in store.contigs})
    monkeypatch.setattr(tsc, "DEVICE_PILEUP_WINDOW", window)
    dispatch.reset()
    got = tsc.call_snps_for_store(store, codes, cfg, threads=4, device=CPU)
    assert dispatch.snapshot()["snp_pileup"]["device"] > 1
    _assert_calls_equal(got, want)


def test_payload_packed_on_device_equals_host_packers(stores):
    """``_payload_on_device`` writes the bytes of duet_tpu's _pack_codes +
    _nibble_pack for odd and even base counts and every qual floor."""
    store, codes = stores[2]
    crs = list(store.contigs.values())
    ref = np.concatenate(list(codes.values()))
    for cut, mbq in ((0, 10), (1, 0), (3, 255), (0, 300), (0, -1)):
        reads = [(cr.seq[cut:], cr.qual[cut:]) for cr in crs]
        n = sum(len(s) for s, _ in reads)
        ns_pad = jsc._pow2(n) * 2
        Lw = jsc._pow2(len(ref))
        want = np.zeros(ns_pad // 2 + Lw, np.uint8)
        jsc._nibble_pack(np.concatenate([jsc._pack_codes(s, q, mbq)
                                         for s, q in reads]), want)
        want[ns_pad // 2:] = 4
        want[ns_pad // 2:ns_pad // 2 + len(ref)] = ref
        got = tsc._payload_on_device(reads, ref, ns_pad, Lw, mbq, CPU)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(mbq))


@pytest.mark.parametrize("chunk", [1000, 4096, 1 << 24])
def test_pileup_lane_chunks_match_jax(monkeypatch, chunk):
    """The device pileup counts its lanes LANE_CHUNK at a time: with
    chunks that split ops, and ops of length zero (the tail pad op), the
    window's output equals duet_tpu's kernel."""
    from duet_tpu.ops import pileup as jp
    from duet_tpu_torch.ops import pileup as tp
    from test_torch_pileup import packed_inputs

    monkeypatch.setattr(tp, "LANE_CHUNK", chunk)
    ops4, payload, total, Lw = packed_inputs(6)
    ops4[2, 3] = 0                    # a zero-length op among the real ones
    want = np.asarray(jp.pileup_call_packed(ops4, payload, total=total,
                                            length=Lw, max_sites=256))
    got = tp.pileup_call_packed(torch.from_numpy(ops4),
                                torch.from_numpy(payload), total=total,
                                length=Lw, max_sites=256)
    np.testing.assert_array_equal(got.numpy(), want)


def test_card_start_only_where_a_card_may_run():
    """The card is brought up beside ingest only on a CUDA device that
    torch sees, with a device route allowed: never on the CPU, never under
    off, and not without a card (the device route raises then)."""
    from duet_tpu_torch.pipeline import PipelineConfig, _start_card

    paths = dict(bam="x.bam", reference="x.fa", output="out")
    for stages in ("auto", "on", "off"):
        assert _start_card(PipelineConfig(device="cpu", device_stages=stages,
                                          **paths)) is None
    assert _start_card(PipelineConfig(device="cuda", device_stages="off",
                                      **paths)) is None
    if not torch.cuda.is_available():
        assert _start_card(PipelineConfig(device="cuda", device_stages="on",
                                          **paths)) is None


def test_warm_up_records_nothing():
    """The phasing kernels' warm-up (here on the CPU) leaves no dispatch or
    cost record and launches no hand kernel, so a run's records hold only
    its own stages."""
    from duet_tpu_torch.ops import haplotag_kernel
    from duet_tpu_torch.ops.sparse_power import warm_up
    from duet_tpu_torch.utils import devcost

    dispatch.reset()
    devcost.reset()
    before = dict(haplotag_kernel.LAUNCHES)
    warm_up(CPU)
    assert dispatch.snapshot() == {} and devcost.snapshot() == {}
    assert haplotag_kernel.LAUNCHES == before


def test_hist_counts_accumulate_across_calls():
    """Counting keys in pieces into one set of bins gives the histogram of
    all of them at once (the lane chunks of ``packed_window_body``)."""
    from duet_tpu_torch.ops.pileup import _hist_counts

    rng = np.random.default_rng(3)
    length = 50
    key = torch.from_numpy(rng.integers(-20, 4 * length + 20, 3000,
                                        dtype=np.int32))
    want = _hist_counts(key, length)
    bins = torch.zeros(4 * length + 1, dtype=torch.int32)
    for part in key.split(700):
        got = _hist_counts(part, length, bins)
    assert torch.equal(got, want)


def test_route_crossover_quick_on_cpu(capsys):
    """Every stage's host and device routes agree at the quick sizes (the
    module asserts it), one row a size (two for the pileup: the store and
    one contig), and the last line derives a gate for every stage and the
    phasing scorer."""
    from duet_tpu_torch import route_crossover

    assert route_crossover.main(["--device", "cpu", "--quick"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    doc = json.loads(lines[-1])
    assert doc["device"] == "cpu" and doc["card"] is None
    q = route_crossover.QUICK
    n_rows = sum(len(v) for v in q.values()) + len(q["pileup"])
    assert len(doc["rows"]) == n_rows == len(lines) - 1
    assert set(doc["gates"]) == {"haplotag_mode", "phasing_min_nnz",
                                 "sv_cluster_min_signatures",
                                 "decide_min_calls", "pileup_min_bases",
                                 "pileup_contig_min_bases"}
    assert doc["gates"]["haplotag_mode"] in ("sparse", "dense")
    for row in doc["rows"]:
        if row["stage"] in ("sv", "decide"):
            assert row["size"] in q[row["stage"]]
        if row["stage"] == "decide":
            assert 0 < row["phased"] <= row["size"]


@pytest.mark.parametrize("rows,gate", [
    # (size, host's fastest and slowest call, the device's)
    ([(1, (2, 3), (1, 1.5)), (2, (2, 3), (1, 1.5))], 1),  # wins everywhere
    ([(1, (1, 1), (2, 2)), (2, (2, 3), (1, 1.5))], 2),    # from the second
    ([(1, (2, 3), (1, 1)), (2, (1, 1), (2, 2)), (3, (3, 4), (1, 2))], 3),
    ([(1, (1, 1), (2, 2)), (2, (1, 1), (2, 2))], None),   # never wins
    # faster at the median but inside the spread: no win
    ([(1, (1.0, 1.3), (0.8, 1.1)), (2, (2, 3), (1, 1.5))], 2),
])
def test_route_crossover_derives_gate(rows, gate):
    from duet_tpu_torch.route_crossover import derive_gate

    assert derive_gate([{"size": s, "host_range": list(h),
                         "device_range": list(d)}
                        for s, h, d in rows]) == gate


def test_route_crossover_tiles_the_simulated_contig():
    """Sizes past the simulated contig's own repeat it along the
    chromosome: each copy shifted by its length, with reads and phase sets
    of its own, and the first copy the contig itself."""
    from duet_tpu_torch.io.vcf import SVRecord
    from duet_tpu_torch.route_crossover import (
        Base,
        tile_callset,
        tile_signatures,
    )

    sigs = (np.array([0, 1, 0]), np.array([10, 20, 30]),
            np.array([60, 70, 80]), np.array([0, 1, 1]))
    recs = [SVRecord("chr1", p, f"c{p}", "N", "<INS>", ".", "PASS", "", "",
                     "", svlen=60, svtype="INS", support=2,
                     read_names=["a", "b"], gt="0/1") for p in (100, 900)]
    base = Base(1000, 2, sigs, recs, {"a": (1, 50, 0), "b": (2, 50, 3)})
    svtype, pos, length, read_idx = tile_signatures(base, 7)
    assert svtype.tolist() == [0, 1, 0, 0, 1, 0, 0]
    assert pos.tolist() == [10, 20, 30, 1010, 1020, 1030, 2010]
    assert length.tolist() == [60, 70, 80, 60, 70, 80, 60]
    assert read_idx.tolist() == [0, 1, 1, 2, 3, 3, 4]
    records, read_hap = tile_callset(base, 3)
    assert [r.pos for r in records] == [100, 900, 1100]
    assert records[2].read_names == ["a/1", "b/1"]
    assert read_hap == {"a/0": (1, 50, 0), "b/0": (2, 50, 3),
                        "a/1": (1, 1050, 0), "b/1": (2, 1050, 3)}
    assert recs[0].read_names == ["a", "b"] and recs[0].pos == 100


def test_stream_scale_device_stages_flag(tmp_path, capsys):
    """``stream_scale --device-stages auto`` runs both modes under auto and
    says so; their artifacts are byte-identical (the module checks).  A
    second call with the same --work reuses the simulated data."""
    from duet_tpu_torch import stream_scale

    assert stream_scale.main(["--contigs", "chr1:60000", "--device", "cpu",
                              "--device-stages", "auto",
                              "--work", str(tmp_path)]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["device_stages"] == "auto"
    assert doc["identical_artifacts"] >= 4
    assert doc["batch"]["device_size_gates"]["haplotag_mode"] in (
        "sparse", "dense")
    assert doc["stream"]["device_size_gates"] == \
        doc["batch"]["device_size_gates"]
    assert doc["stream_no_prefetch"]["peak_rss_mb"] > 0
    assert doc["largest_contig_columns_mb"] > 0
    assert doc["sim_s"] is not None
    # a second run in the same --work reuses its data
    assert stream_scale.main(["--contigs", "chr1:60000", "--device", "cpu",
                              "--device-stages", "off",
                              "--work", str(tmp_path)]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["sim_s"] is None and again["device_stages"] == "off"
    assert again["batch"]["snp_sites"] == doc["batch"]["snp_sites"]


def test_device_size_gates_report_the_pileup_gates():
    """Under --snp-model counts metrics.json's record of auto's gates holds
    the pileup's two, the whole store's and one contig's, which route the
    counting rule."""
    from duet_tpu_torch.pipeline import PipelineConfig

    gates = PipelineConfig(bam="", reference="", output="", device="cpu",
                           snp_model="counts").device_size_gates()
    assert gates["pileup_min_bases"] == \
        PipelineConfig.PILEUP_GATE_H100_BASES == 41_494_548
    assert gates["pileup_contig_min_bases"] == \
        PipelineConfig.PILEUP_CONTIG_GATE_H100_BASES == 20_735_789


@pytest.mark.parametrize("model", ["auto", "nn"])
def test_device_size_gates_leave_the_pileup_to_counts(model):
    """Under any other --snp-model no size sends the pileup to the device,
    and the record says so: both pileup gates None."""
    from duet_tpu_torch.pipeline import PipelineConfig

    cfg = PipelineConfig(bam="", reference="", output="", device="cpu",
                         snp_model=model)
    gates = cfg.device_size_gates()
    assert gates["pileup_min_bases"] is None
    assert gates["pileup_contig_min_bases"] is None
    assert cfg.pileup_gate() is None and cfg.pileup_gate(stream=True) is None


@pytest.mark.parametrize("stream", [False, True])
def test_auto_routes_the_pileup_by_its_gate(sim_dataset, tmp_path,
                                            monkeypatch, stream):
    """auto with --snp-model counts sends the pileup to the device from
    its gate (the whole store's in a batch run, one contig's under
    --stream) and keeps it on the host below it; either way the
    artifacts are duet_tpu's."""
    from duet_tpu.pipeline import PipelineConfig as JaxConfig
    from duet_tpu.pipeline import run_pipeline as jax_run
    from duet_tpu_torch.pipeline import (PipelineConfig, run_pipeline,
                                         run_pipeline_streaming)
    from test_torch_pipeline import _artifacts, _read

    monkeypatch.setattr(PipelineConfig, "stages_on_device",
                        lambda self: self.device_stages != "off")
    data, _, _ = sim_dataset
    paths = dict(bam=os.path.join(data, "reads.bam"),
                 reference=os.path.join(data, "ref.fa"))
    want = str(tmp_path / "jax")
    jax_run(JaxConfig(output=want, snp_model="counts", **paths))
    n_bases = sum(len(cr.seq) for cr in load_read_store(
        paths["bam"]).contigs.values())
    gate = "PILEUP_CONTIG_GATE_H100_BASES" if stream \
        else "PILEUP_GATE_H100_BASES"
    other = "PILEUP_GATE_H100_BASES" if stream \
        else "PILEUP_CONTIG_GATE_H100_BASES"
    monkeypatch.setattr(PipelineConfig, other, 1)   # the other shape's
    for at, route in ((n_bases, "device"), (n_bases + 1, "host")):
        monkeypatch.setattr(PipelineConfig, gate, at)
        got = str(tmp_path / f"torch_{at}")
        run = run_pipeline_streaming if stream else run_pipeline
        run(PipelineConfig(output=got, device="cpu", snp_model="counts",
                           **paths))
        with open(os.path.join(got, "metrics.json")) as f:
            metrics = json.load(f)
        assert metrics["backends"]["snp_pileup"] == route
        assert metrics["device_size_gates"][
            "pileup_contig_min_bases" if stream else "pileup_min_bases"] == at
        assert _artifacts(got) == _artifacts(want)
        for name in _artifacts(want):
            assert _read(os.path.join(got, name)) == \
                _read(os.path.join(want, name)), name
