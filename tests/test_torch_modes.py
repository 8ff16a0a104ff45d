"""The torch port's --stream, --resume and --phase-only modes against
duet_tpu's on the CPU: every artifact byte-identical (the tolerance is
none), the streaming metrics schema, the unsorted-BAM refusal, the
FORMAT-aware pileup reader resume needs, and the three modes through the
CLI."""

import gzip
import json
import os
import shutil

import numpy as np
import pytest
import torch

from duet_tpu.io.vcf import write_vcf
from duet_tpu.models.snp_caller import read_pileup_vcf as jax_read_pileup
from duet_tpu.pipeline import PipelineConfig as JaxConfig
from duet_tpu.pipeline import run_phase_only as jax_phase_only
from duet_tpu.pipeline import run_pipeline as jax_run
from duet_tpu.pipeline import run_pipeline_streaming as jax_stream
from duet_tpu_torch.cli import main as cli_main
from duet_tpu_torch.models.snp_caller_host import read_pileup_vcf
from duet_tpu_torch.pipeline import (
    PipelineConfig,
    run_phase_only,
    run_pipeline,
    run_pipeline_streaming,
)

STAGES = ("snp_pileup", "sv_cluster", "phase_refine", "haplotag", "sv_decide")
ARTIFACT_DIRS = ("snp_calling", "sv_calling", "snp_phasing")


def artifact_tree(out):
    """Relative path -> content of every artifact a run wrote (the stage
    directories and phased_sv.vcf; not the log or metrics.json).  BGZF
    files are compared decompressed, everything else byte for byte."""
    tree = {}
    for d in ARTIFACT_DIRS:
        if not os.path.isdir(os.path.join(out, d)):
            continue
        for name in sorted(os.listdir(os.path.join(out, d))):
            path = os.path.join(out, d, name)
            if name.endswith(".gz"):
                with gzip.open(path, "rb") as f:
                    tree[f"{d}/{name}"] = f.read()
            else:
                with open(path, "rb") as f:
                    tree[f"{d}/{name}"] = f.read()
    with open(os.path.join(out, "phased_sv.vcf"), "rb") as f:
        tree["phased_sv.vcf"] = f.read()
    return tree


def assert_same_artifacts(got, want):
    a, b = artifact_tree(got), artifact_tree(want)
    assert list(a) == list(b)
    for name in b:
        assert a[name] == b[name], name


def _paths(data):
    return dict(bam=os.path.join(data, "reads.bam"),
                reference=os.path.join(data, "ref.fa"))


@pytest.fixture(scope="module")
def two_contigs(tmp_path_factory):
    """Two contigs, so the streaming loop crosses a contig boundary."""
    from duet_tpu.sim import SimConfig, simulate_dataset

    out = tmp_path_factory.mktemp("two_contigs")
    simulate_dataset(str(out), SimConfig(
        contigs={"chr1": 90_000, "chr2": 70_000}, seed=13, coverage=14.0,
        read_len_mean=8_000))
    return str(out)


@pytest.mark.parametrize("use_device", [True, False])
def test_phase_contig_matches_duet_tpu(sim_dataset, use_device):
    """The streaming run's per-contig phasing: refine and read scoring
    (the dense windowed route when use_device) equal duet_tpu's
    phase_contig field by field."""
    from duet_tpu.io.fasta import FastaFile
    from duet_tpu.io.readstore import load_read_store as jax_load
    from duet_tpu.models.snp_caller import call_snps_for_store
    from duet_tpu.models.snp_phaser import phase_contig as jax_phase
    from duet_tpu_torch.io.readstore import load_read_store
    from duet_tpu_torch.models.snp_caller_host import ContigSnps
    from duet_tpu_torch.models.snp_phaser import phase_contig

    bam = os.path.join(sim_dataset[0], "reads.bam")
    j_store, t_store = jax_load(bam), load_read_store(bam)
    (contig, j_cr), = j_store.contigs.items()
    codes = FastaFile(os.path.join(sim_dataset[0], "ref.fa")).fetch_codes(
        contig)
    j_snps = call_snps_for_store(j_store, {contig: codes})[0][contig]
    t_snps = ContigSnps(**{f: getattr(j_snps, f)
                           for f in ContigSnps.__dataclass_fields__})
    want = jax_phase(j_cr, j_snps, use_device=use_device)
    got = phase_contig(t_store.contigs[contig], t_snps,
                       use_device=use_device, device=torch.device("cpu"))
    assert got.row_names == want.row_names
    for f in ("site_pos", "phase", "block_id", "block_ps", "read_hap",
              "read_ps", "read_pc"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert (got.read_hap != 0).sum() > 0


@pytest.mark.parametrize("dataset", ["sim_dataset", "two_contigs"])
@pytest.mark.parametrize("mode", ["on", "off"])
def test_stream_matches_duet_tpu_and_batch(request, tmp_path, mode, dataset):
    data = request.getfixturevalue(dataset)
    data = data[0] if isinstance(data, tuple) else data
    jax_stream(JaxConfig(output=str(tmp_path / "jax"), device_stages=mode,
                         **_paths(data)))
    run_pipeline_streaming(PipelineConfig(
        output=str(tmp_path / "stream"), device_stages=mode, device="cpu",
        **_paths(data)))
    run_pipeline(PipelineConfig(output=str(tmp_path / "batch"),
                                device_stages=mode, device="cpu",
                                **_paths(data)))
    assert_same_artifacts(tmp_path / "stream", tmp_path / "jax")
    assert_same_artifacts(tmp_path / "stream", tmp_path / "batch")
    with open(tmp_path / "stream" / "metrics.json") as f:
        backends = json.load(f)["backends"]
    # the BGZF inflate's card route runs on CUDA only
    assert backends == {**dict.fromkeys(
        STAGES, "device" if mode == "on" else "host"),
        "ingest_inflate": "host"}


def test_stream_metrics_schema(sim_dataset, tmp_path):
    """duet_tpu's streaming metrics.json keys plus the port's "device" and
    its span registry, less the JAX package's link-probe keys (the port
    runs no probe)."""
    data = sim_dataset[0]
    jax_stream(JaxConfig(output=str(tmp_path / "jax"), device_stages="on",
                         **_paths(data)))
    run_pipeline_streaming(PipelineConfig(
        output=str(tmp_path / "torch"), device_stages="on", device="cpu",
        **_paths(data)))
    with open(tmp_path / "jax" / "metrics.json") as f:
        want = json.load(f)
    with open(tmp_path / "torch" / "metrics.json") as f:
        got = json.load(f)
    probe = {"h2d_probe_mb_s", "h2d_worst_put_s"}
    assert probe <= set(want)
    assert set(got) == (set(want) - probe) | {"device", "spans", "counters"}
    assert got["mode"] == "streaming"
    assert not probe & set(got)
    assert got["device"] == {"type": "cpu", "name": None}
    assert got["counts"] == want["counts"]
    assert set(got["stages"]) == set(want["stages"])
    assert set(got["stage_peak_rss_mb"]) == set(want["stage_peak_rss_mb"])
    for stage, rss in got["stage_peak_rss_mb"].items():
        assert rss > 0 and got["stages"][stage] >= 0, stage
    assert set(got["device_cost"]) == set(STAGES)


def test_stream_rejects_unsorted_bam(tmp_path):
    """A contig in two stream segments (a BAM not coordinate-sorted) fails
    loudly, as in tests/test_streaming.py."""
    from duet_tpu_torch.io.bam import BamHeader, BamRead, BamWriter, \
        write_bam_index
    from duet_tpu_torch.io.fasta import write_fasta

    rng = np.random.default_rng(11)
    seqs = {c: "".join(rng.choice(list("ACGT"), 4000)) for c in ("c1", "c2")}
    ref = str(tmp_path / "ref.fa")
    write_fasta(ref, seqs)
    header = BamHeader("@HD\tVN:1.6\n@SQ\tSN:c1\tLN:4000\n"
                       "@SQ\tSN:c2\tLN:4000\n", ["c1", "c2"], [4000, 4000])
    path = str(tmp_path / "reads.bam")
    with BamWriter(path, header) as w:
        for k, rid in enumerate((0, 1, 0)):  # c1, c2, c1 again
            seq = rng.integers(0, 4, size=200).astype(np.uint8)
            w.write(BamRead(f"r{k}", 0, rid, 100, 60,
                            np.array([[0, 200]], np.int32), seq,
                            np.full(200, 30, np.uint8), {}))
    write_bam_index(path)
    cfg = PipelineConfig(bam=path, reference=ref,
                         output=str(tmp_path / "out"), device="cpu",
                         device_stages="off", include_all_ctgs=True)
    with pytest.raises(ValueError, match="coordinate-sorted"):
        run_pipeline_streaming(cfg)


def test_stream_reader_holds_no_contig_it_yielded(two_contigs, monkeypatch):
    """After each contig the native stream yields, its reader holds none of
    that contig's bytes: its window holds at most what follows the contig
    in the inflated stream (one refill's worth), and nothing at the end."""
    import ctypes
    import struct

    from duet_tpu_torch.io import native_ingest
    from duet_tpu_torch.io.bgzf import bgzf_decompress_file
    from duet_tpu_torch.utils import spans

    try:
        lib = native_ingest.get_lib()
    except native_ingest.NativeUnavailable as e:
        pytest.skip(f"the native ingest does not build here: {e}")
    bam = os.path.join(two_contigs, "reads.bam")
    data = bgzf_decompress_file(bam)
    # where each reference's last record ends in the inflated stream
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        off += 8 + struct.unpack_from("<i", data, off)[0]
    ends = {}
    while off < len(data):
        size, rid = struct.unpack_from("<ii", data, off)
        off += 4 + size
        ends[rid] = off
    handles = []
    fetch = native_ingest._fetch_contig

    def spy(lib_, h, name):
        handles.append(h)
        return fetch(lib_, h, name)

    monkeypatch.setattr(native_ingest, "_fetch_contig", spy)
    spans.reset()
    held = {}
    for cr, _ in native_ingest.stream_read_store_native(bam, n_threads=2):
        held[cr.contig] = lib.duet_bam_held_bytes(
            ctypes.c_void_p(handles[-1]))
    assert list(held) == ["chr1", "chr2"]
    # the window rounds up to whole pages
    assert 0 < held["chr1"] < len(data) - ends[0] + 4096
    assert held["chr2"] == 0
    stats = native_ingest.decode_stats()
    assert held["chr1"] < stats["bytes_inflated"] / stats["inflate_batches"]


@pytest.mark.parametrize("source", ["tsv", "bam"])
def test_phase_only_matches_duet_tpu(sim_dataset, tmp_path, source):
    """Phase-only from the framework's .haplotags.tsv tables, or from the
    haplotagged BAMs --haplotag-bam writes (the reference's data plane):
    the port and duet_tpu write the same phased_sv.vcf, which equals the
    full run's."""
    full = tmp_path / "full"
    run_pipeline(PipelineConfig(output=str(full), device_stages="on",
                                device="cpu", haplotag_bam=True,
                                **_paths(sim_dataset[0])))
    keep = ".haplotags.tsv" if source == "tsv" else ".bam"
    outs = {}
    for pkg in ("jax", "torch"):
        po = tmp_path / pkg
        (po / "sv_calling").mkdir(parents=True)
        (po / "snp_phasing").mkdir()
        shutil.copy(full / "sv_calling" / "variants.vcf", po / "sv_calling")
        for f in (full / "snp_phasing").iterdir():
            if f.name.endswith(keep):
                shutil.copy(f, po / "snp_phasing")
        outs[pkg] = po
    jax_phase_only(JaxConfig(bam="", reference="", output=str(outs["jax"]),
                             device_stages="on"))
    run_phase_only(PipelineConfig(bam="", reference="",
                                  output=str(outs["torch"]),
                                  device_stages="on", device="cpu"))
    with open(outs["torch"] / "phased_sv.vcf", "rb") as f:
        got = f.read()
    with open(outs["jax"] / "phased_sv.vcf", "rb") as f:
        assert got == f.read()
    with open(full / "phased_sv.vcf", "rb") as f:
        assert got == f.read()


def _clair3_style_vcf(path, snps):
    """snps re-emitted in Clair3's layout (FORMAT GT:GQ:DP:AF), as in
    tests/test_clair3_resume.py."""
    header = [
        "##fileformat=VCFv4.2",
        "##source=Clair3",
        "##contig=<ID=chr21>",
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">',
        '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="GQ">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="DP">',
        '##FORMAT=<ID=AF,Number=1,Type=Float,Description="AF">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE",
    ]
    recs = []
    for contig, s in snps.items():
        for k in range(len(s.pos)):
            gt = "0/1" if s.is_het[k] else "1/1"
            af = s.alt_count[k] / max(int(s.depth[k]), 1)
            recs.append(
                f"{contig}\t{s.pos[k] + 1}\t.\t"
                f"{'ACGT'[s.ref_code[k]]}\t{'ACGT'[s.alt_code[k]]}\t12.3\t"
                f"PASS\t.\tGT:GQ:DP:AF\t{gt}:15:{s.depth[k]}:{af:.4f}"
            )
    write_vcf(path, header, recs)


@pytest.mark.parametrize("start", ["clair3", "full"])
def test_resume_matches_duet_tpu(sim_dataset, tmp_path, start):
    """--resume from a Clair3-style pileup (SNP calling skipped, SV calling
    runs) or from a full run's directory (both calling stages skipped, the
    variants parsed for the protect intervals): the port and duet_tpu write
    the same artifacts, and the phased callset equals the base run's."""
    paths = _paths(sim_dataset[0])
    base = tmp_path / "base"
    run_pipeline(PipelineConfig(output=str(base), device_stages="on",
                                device="cpu", **paths))
    outs = {pkg: tmp_path / pkg for pkg in ("jax", "torch")}
    for out in outs.values():
        if start == "full":
            shutil.copytree(base, out)
        else:
            os.makedirs(out / "snp_calling")
            _clair3_style_vcf(str(out / "snp_calling" / "pileup.vcf.gz"),
                              read_pileup_vcf(str(base / "snp_calling"
                                                  / "pileup.vcf.gz")))
    jax_run(JaxConfig(output=str(outs["jax"]), device_stages="on",
                      resume=True, **paths))
    run_pipeline(PipelineConfig(output=str(outs["torch"]), device_stages="on",
                                device="cpu", resume=True, **paths))
    assert_same_artifacts(outs["torch"], outs["jax"])
    assert artifact_tree(outs["torch"])["phased_sv.vcf"] == \
        artifact_tree(base)["phased_sv.vcf"]
    with open(outs["torch"] / "run_duet.log") as f:
        log = f.read()
    assert "resume: loading" in log
    assert ("resume: keeping" in log) == (start == "full")


EDGE_CASES = {
    # tests/test_clair3_resume.py::test_clair3_parser_edge_cases
    "edges": ("p.vcf", [
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"], [
        "chr1\t100\t.\tA\tC\t.\tPASS\t.\tGT:DP:AF\t0/1:20:0.45",
        "chr1\t200\t.\tG\tT,A\t.\tPASS\t.\tGT:DP:AF\t1|1:30:0.97",
        "chr1\t300\t.\tACG\tA\t.\tPASS\t.\tGT:DP:AF\t0/1:25:0.4",
        "chr1\t400\t.\tC\tG\t.\tPASS\t.\tGT:DP:AF\t0/0:25:0.01",
        "chr1\t500\t.\tT\tA\t.\tPASS\t.\tGT:AD\t0/1:11,9"]),
    # ...::test_multiallelic_het_resumes_as_het
    "multiallelic": ("pileup.vcf.gz", [
        "##fileformat=VCFv4.2",
        "##contig=<ID=chr21>",
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="DP">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE"], [
        "chr21\t100\t.\tA\tC,G\t10\tPASS\t.\tGT:DP\t1/2:20",
        "chr21\t200\t.\tA\tC\t10\tPASS\t.\tGT:DP\t0/1:20",
        "chr21\t300\t.\tA\tC\t10\tPASS\t.\tGT:DP\t1|1:20",
        "chr21\t400\t.\tA\tC,G\t10\tPASS\t.\tGT:DP\t2/1:20"]),
    # AF absent and AD without an alt count: the het/hom fallback; a
    # record with fewer than ten columns is skipped
    "fallbacks": ("f.vcf", [
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"], [
        "chr2\t10\t.\tA\tG\t.\tPASS\t.\tGT:DP\t0/1:17",
        "chr2\t20\t.\tc\tt\t.\tPASS\t.\tGT:DP:AD\t1/1:12:.,.",
        "chr2\t30\t.\tA\tN\t.\tPASS\t.\tGT:DP:AF\t0|1:9:x",
        "chr2\t40\t.\tA\tG\t.\tPASS\t.\tGT:DP",
        "chr3\t5\t.\tT\tC\t.\tPASS\t.\tGT\t./."]),
}
EDGE_EXPECT = {
    "edges": {"chr1": dict(pos=[99, 199, 499], is_het=[True, False, True],
                           alt_count=[9, 29, 9], depth=[20, 30, 20])},
    "multiallelic": {"chr21": dict(pos=[99, 199, 299, 399],
                                   is_het=[True, True, False, True],
                                   alt_code=[1, 1, 1, 1])},
    "fallbacks": {"chr2": dict(pos=[9, 19, 29], is_het=[True, False, True],
                               alt_count=[8, 12, 4], ref_code=[0, 1, 0],
                               alt_code=[2, 3, 4])},
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_read_pileup_vcf_matches_duet_tpu(tmp_path, case):
    name, header, recs = EDGE_CASES[case]
    path = str(tmp_path / name)
    write_vcf(path, header, recs, index=False)
    got, want = read_pileup_vcf(path), jax_read_pileup(path)
    assert list(got) == list(want) == list(EDGE_EXPECT[case])
    for contig, fields in EDGE_EXPECT[case].items():
        g, w = got[contig], want[contig]
        for f in ("pos", "ref_code", "alt_code", "is_het", "depth",
                  "alt_count"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f)
            assert getattr(g, f).dtype == getattr(w, f).dtype, f
        for f, values in fields.items():
            assert list(getattr(g, f)) == values, f


def _cli(data, out, *flags):
    rc = cli_main([os.path.join(data, "reads.bam"),
                   os.path.join(data, "ref.fa"), str(out), "--device", "cpu",
                   "--device-stages", "on", *flags])
    assert rc == 0


@pytest.mark.parametrize("mode", ["--stream", "--resume", "--phase-only"])
def test_modes_through_cli(sim_dataset, tmp_path, mode):
    """Each mode runs through duet-tpu-torch's CLI and writes the batch
    run's phased_sv.vcf."""
    data = sim_dataset[0]
    batch = tmp_path / "batch"
    _cli(data, batch)
    out = tmp_path / "mode"
    if mode == "--resume":
        shutil.copytree(batch, out)
    elif mode == "--phase-only":
        for d in ("sv_calling", "snp_phasing"):
            shutil.copytree(batch / d, out / d)
    _cli(data, out, mode)
    with open(out / "phased_sv.vcf", "rb") as f:
        got = f.read()
    with open(batch / "phased_sv.vcf", "rb") as f:
        assert got == f.read()
    if mode == "--stream":
        assert_same_artifacts(out, batch)
        with open(out / "metrics.json") as f:
            assert json.load(f)["mode"] == "streaming"
