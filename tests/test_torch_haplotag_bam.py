"""The port's haplotagged-BAM writer against duet_tpu's, on the CPU: the
pooled BGZF writer writes duet_tpu's blocks whatever its pool size, the
column-wise record encoder writes what duet_tpu's per-read BamWriter
writes, and the .bai built from the writer's own offsets is the one
duet_tpu's build_bai reads back from the file.  The tolerance is none:
bytes are compared.

Inputs come from ``np.random.default_rng(seed)`` and from the session's
simulated dataset; the last case puts a record's start exactly on a BGZF
block boundary."""

import dataclasses
import io
import os
import shutil

import numpy as np
import pytest

from duet_tpu import pipeline as j_pipeline
from duet_tpu.io.bai import build_bai as j_build_bai
from duet_tpu.io.bam import BamHeader as JBamHeader
from duet_tpu.io.bam import BamRead as JBamRead
from duet_tpu.io.bam import BamWriter as JBamWriter
from duet_tpu.io.bgzf import BgzfWriter as JBgzfWriter
from duet_tpu.io.bgzf import bgzf_decompress_file
from duet_tpu_torch import pipeline as t_pipeline
from duet_tpu_torch.io import bam as t_bam
from duet_tpu_torch.io.bam import encode_header, encode_records
from duet_tpu_torch.io.bgzf import BgzfWriter
from duet_tpu_torch.io.readstore import ContigReads
from duet_tpu_torch.io.tabix import reg2bins

BLOCK = 0xFF00  # a BGZF block's payload


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


SIZES = [0, 1, BLOCK - 1, BLOCK, BLOCK + 1, 5 * BLOCK + 17]


@pytest.mark.parametrize("threads", [1, 2, 8])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("calls", ["one", "many"])
def test_pooled_bgzf_writer_writes_duet_tpus_blocks(threads, size, calls):
    rng = np.random.default_rng(size + threads)
    # half random bytes, half a repeated motif: blocks that deflate to
    # different sizes, so the compressed offsets are uneven
    data = rng.integers(0, 256, size, dtype=np.uint8)
    data[size // 2:] = np.resize(np.frombuffer(b"ACGTTGCA", np.uint8),
                                 size - size // 2)
    data = data.tobytes()
    cuts = [0, size] if calls == "one" else \
        [0, *sorted(rng.integers(0, size + 1, 40).tolist()), size]
    want, got = io.BytesIO(), io.BytesIO()
    with JBgzfWriter(want) as j, BgzfWriter(got, threads=threads) as t:
        for a, b in zip(cuts, cuts[1:]):
            j.write(data[a:b])
            t.write(data[a:b])
    assert got.getvalue() == want.getvalue()
    if size:
        # every offset's block: one on a boundary is the next block's
        u = np.arange(0, size, max(size // 7, 1))
        vo = t.voffsets(u)
        assert np.array_equal(vo & 0xFFFF, u % BLOCK)
        assert np.all(np.diff(vo >> 16)[np.diff(u // BLOCK) == 0] == 0)


def _random_haps(names, seed, share=0.6):
    rng = np.random.default_rng(seed)
    return {nm: (int(rng.integers(1, 3)), int(rng.integers(0, 2 ** 31)),
                 int(rng.integers(0, 60)))
            for nm in names if rng.random() < share}


def _empty_contig(name):
    z = np.zeros(0, np.int64)
    return ContigReads(name, 0, [], z, z.copy(), np.zeros(0, np.uint8),
                       np.zeros(0, np.uint8), np.zeros(0, np.uint8),
                       np.zeros(1, np.int64), np.zeros(0, np.int8),
                       np.zeros(0, np.int32), np.zeros(1, np.int64),
                       np.zeros(0, np.uint8), np.zeros(0, np.uint8))


@pytest.fixture(scope="module")
def sim_store(sim_dataset):
    from duet_tpu_torch.io.readstore import load_read_store

    return load_read_store(os.path.join(sim_dataset[0], "reads.bam"))


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("case", ["tagged", "untagged", "no_reads"])
def test_haplotag_bam_and_index_equal_duet_tpus(sim_store, tmp_path, case,
                                                threads):
    cr = sim_store.contigs["chr21"]
    haps = {"tagged": _random_haps(cr.names, 5), "untagged": {},
            "no_reads": {}}[case]
    if case == "tagged":
        # reverse and supplementary reads among them
        rng = np.random.default_rng(11)
        cr = dataclasses.replace(
            cr, strand=rng.integers(0, 2, cr.n).astype(np.uint8),
            supp=(rng.random(cr.n) < 0.2).astype(np.uint8))
    if case == "no_reads":
        cr = _empty_contig("chr21")
    lengths = sim_store.contig_lengths
    j_pipeline._write_haplotag_bam(str(tmp_path / "j.bam"), cr, haps,
                                   lengths)
    split = t_pipeline._write_haplotag_bam(str(tmp_path / "t.bam"), cr,
                                           haps, lengths, threads=threads)
    assert _bytes(tmp_path / "t.bam") == _bytes(tmp_path / "j.bam")
    assert _bytes(tmp_path / "t.bam.bai") == _bytes(tmp_path / "j.bam.bai")
    assert split["bytes"] == os.path.getsize(tmp_path / "t.bam")
    assert {"encode_s", "compress_s", "index_s"} <= set(split)


def _reads(lengths, names, strand, supp, cigars, seed):
    """Reads with these lengths, names, flags and CIGARs, random bases,
    qualities and sorted positions, as ContigReads."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 5, n).astype(np.uint8) for n in lengths]
    quals = [rng.integers(0, 60, n).astype(np.uint8) for n in lengths]
    starts = np.sort(rng.integers(0, 1 << 20, len(lengths))).astype(np.int64)
    c_off = np.concatenate([[0], np.cumsum([len(c) for c in cigars])])
    s_off = np.concatenate([[0], np.cumsum(lengths)])
    ops = np.array([op for c in cigars for op, _ in c], np.int8)
    lens = np.array([ln for c in cigars for _, ln in c], np.int32)
    return ContigReads(
        "chrB", len(lengths), names, starts, starts + 1,
        np.array(strand, np.uint8),
        rng.integers(0, 61, len(lengths)).astype(np.uint8),
        np.array(supp, np.uint8), c_off.astype(np.int64), ops, lens,
        s_off.astype(np.int64), np.concatenate(seqs), np.concatenate(quals))


@pytest.mark.parametrize("chunk_bytes", [1, 300, 8 << 20])
def test_encoder_writes_the_per_read_writers_records(tmp_path, monkeypatch,
                                                     chunk_bytes):
    """Odd and even lengths, an empty sequence, no CIGAR, a CIGAR with no
    reference-consuming op, reverse and supplementary reads, reads past
    one bin level, long and non-ASCII names: each record equal to
    duet_tpu's."""
    lengths = [7, 8, 0, 1, 2, 15, 30, 11]
    names = ["r0", "read_" + "x" * 200, "r2", "\u00e93", "r4", "r5", "r6",
             "r7"]
    cigars = [[(0, 7)], [(4, 2), (0, 4), (1, 1), (2, 5), (0, 1)], [],
              [(4, 1)], [(0, 2), (3, 40000)], [(5, 3), (0, 15), (5, 9)],
              [(7, 10), (8, 1), (7, 19)], [(0, 5), (2, 70000), (0, 6)]]
    cr = _reads(lengths, names, [0, 1, 0, 1, 1, 0, 1, 0],
                [0, 0, 1, 1, 0, 1, 0, 0], cigars, seed=3)
    haps = _random_haps(names, 7, share=0.5)
    haps[names[0]] = (2, 2 ** 31 - 1, 0)
    header = JBamHeader("@HD\tVN:1.6\n", ["chrB"], [1 << 21])
    with JBamWriter(str(tmp_path / "j.bam"), header) as w:
        for i in range(cr.n):
            t = haps.get(cr.names[i])
            w.write(JBamRead(
                cr.names[i], (0x10 if cr.strand[i] else 0)
                | (0x800 if cr.supp[i] else 0), 0, int(cr.starts[i]),
                int(cr.mapq[i]),
                np.array(cigars[i], np.int32).reshape(-1, 2),
                cr.seq[cr.seq_off[i]:cr.seq_off[i + 1]],
                cr.qual[cr.seq_off[i]:cr.seq_off[i + 1]],
                {} if t is None else {"HP": t[0], "PC": t[2], "PS": t[1]}))
    data = bgzf_decompress_file(str(tmp_path / "j.bam"))
    head = encode_header(header)
    assert data[:len(head)] == head
    monkeypatch.setattr(t_bam, "CHUNK_BYTES", chunk_bytes)
    pos, end, sizes, chunks = encode_records(cr, haps)
    assert b"".join(chunks) == data[len(head):]
    assert int(sizes.sum()) == len(data) - len(head)
    np.testing.assert_array_equal(pos, cr.starts)


def test_encoder_refuses_what_a_record_cannot_hold():
    cr = _reads([3], ["r"], [0], [0], [[(0, 3)]], seed=1)
    with pytest.raises(ValueError, match="int32"):
        encode_records(cr, {"r": (1, 2 ** 31, 0)})
    bad = _reads([3], ["r"], [0], [0], [[(0, 3)]], seed=1)
    bad.seq[0] = 9
    with pytest.raises(ValueError, match="base code"):
        encode_records(bad, {})


def test_index_of_a_record_on_a_block_boundary(tmp_path):
    """A record whose first byte is a block's first byte: its chunk starts
    at (that block's offset, 0), as build_bai's reader reports it."""
    length = 1 << 20
    head = len(encode_header(JBamHeader(
        f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chrB\tLN:{length}\n",
        ["chrB"], [length])))
    # record size 36 + name with its NUL + 4 + ceil(l / 2) + l; pick the
    # name and l so that the header and the first record fill the first
    # block exactly
    target = BLOCK - head
    name, n_bases = next((nm, n) for nm in ("r0", "r00")
                         for n in range(40_000, 45_000)
                         if 36 + len(nm) + 1 + 4 + (n + 1) // 2 + n == target)
    lengths = [n_bases, 5000, 12, 30000]
    cr = _reads(lengths, [name, "r1", "r2", "r3"], [0, 1, 0, 0],
                [0, 0, 1, 0], [[(0, n)] for n in lengths], seed=2)
    j_pipeline._write_haplotag_bam(str(tmp_path / "j.bam"), cr, {},
                                   {"chrB": length})
    t_pipeline._write_haplotag_bam(str(tmp_path / "t.bam"), cr, {},
                                   {"chrB": length}, threads=2)
    assert _bytes(tmp_path / "t.bam") == _bytes(tmp_path / "j.bam")
    want = j_build_bai(str(tmp_path / "j.bam"))
    assert _bytes(tmp_path / "t.bam.bai") == want
    # the second record's chunk starts at the second block, offset 0
    first_block = int.from_bytes(_bytes(tmp_path / "t.bam")[16:18],
                                 "little") + 1
    assert (first_block << 16).to_bytes(8, "little") in want


@pytest.mark.parametrize("beg,end", [(0, 1 << 60), (-5, 1 << 29),
                                     (1 << 20, 1 << 40)])
def test_reg2bins_clamps_to_the_binned_space(beg, end):
    """A region reaching past the binned space [0, 2^29) gets duet_tpu's
    bins for the part inside it (duet_tpu's own would list 2^46 bins for
    an end of 2^60)."""
    from duet_tpu.io.tabix import reg2bins as j_reg2bins

    got = reg2bins(beg, end)
    assert got == j_reg2bins(max(beg, 0), min(end, 1 << 29))
    assert len(got) <= 37_450  # every bin of the scheme


@pytest.fixture(scope="module")
def two_contigs(tmp_path_factory):
    from duet_tpu.sim import SimConfig, simulate_dataset

    out = tmp_path_factory.mktemp("two_contigs_bam")
    simulate_dataset(str(out), SimConfig(
        contigs={"chr1": 90_000, "chr2": 70_000}, seed=13, coverage=14.0,
        read_len_mean=8_000))
    return str(out)


def _bams(out):
    d = os.path.join(out, "snp_phasing")
    return {n: _bytes(os.path.join(d, n)) for n in sorted(os.listdir(d))
            if n.endswith((".bam", ".bai"))}


@pytest.mark.parametrize("mode", ["resume", "two_processes"])
def test_flag_under_resume_and_two_processes(two_contigs, tmp_path, mode):
    """--haplotag-bam reaches the same writer under --resume and in each
    process of a multi-process run (emulated: process 1, then 0, on one
    OUTPUT): every BAM and .bai equal to duet_tpu's."""
    from duet_tpu.pipeline import PipelineConfig as JaxConfig
    from duet_tpu.pipeline import run_pipeline as jax_run
    from duet_tpu_torch.pipeline import PipelineConfig, run_pipeline

    paths = dict(bam=f"{two_contigs}/reads.bam",
                 reference=f"{two_contigs}/ref.fa", include_all_ctgs=True,
                 haplotag_bam=True)
    outs = {pkg: tmp_path / pkg for pkg in ("jax", "torch")}
    if mode == "resume":
        base = tmp_path / "base"
        run_pipeline(PipelineConfig(output=str(base), device="cpu",
                                    device_stages="on", **paths))
        for out in outs.values():
            os.makedirs(out)
            for d in ("snp_calling", "sv_calling"):
                shutil.copytree(base / d, out / d)
        runs = [dict(resume=True)]
    else:
        runs = [dict(num_processes=2, process_id=p) for p in (1, 0)]
    for kw in runs:
        jax_run(JaxConfig(output=str(outs["jax"]), device_stages="on",
                          **paths, **kw))
        run_pipeline(PipelineConfig(output=str(outs["torch"]), device="cpu",
                                    device_stages="on", **paths, **kw))
    got, want = _bams(outs["torch"]), _bams(outs["jax"])
    assert sorted(got) == ["chr1.bam", "chr1.bam.bai", "chr2.bam",
                           "chr2.bam.bai"]
    assert got == want
