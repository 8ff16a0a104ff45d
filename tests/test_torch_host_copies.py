"""The port's copies of duet_tpu's host layers, held against the originals
on the CPU: the simulator writes the same bytes, the readers build the same
read store (the native one from the port's zlib build of the ingest source
against duet_tpu's build), the VCF parsers read duet_tpu's files into the
same records, the VCF writers write duet_tpu's bytes from the same content,
and the module constants, config defaults, CLI flags and shipped weights
are equal.  The port's ingest source differs from the shared one only in
its inflate and in the release of a contig once copied out, and both
native readers reject a corrupt BGZF member.

The port's dataclasses are classes of their own, so objects cross packages
field by field (``_as``) and are compared field by field."""

import ast
import dataclasses
import gzip
import os

import numpy as np
import pytest

from duet_tpu import cli as j_cli
from duet_tpu import pipeline as j_pipeline
from duet_tpu.io import readstore as j_readstore
from duet_tpu.io import vcf as j_vcf
from duet_tpu.models import decision_model as j_decision
from duet_tpu.models import nn_snp as j_nn
from duet_tpu.models import snp_caller as j_snp
from duet_tpu.models import snp_phaser as j_phaser
from duet_tpu.models import sv_caller as j_sv
from duet_tpu.models import sv_phaser as j_svp
from duet_tpu.sim import SimConfig as JSimConfig
from duet_tpu.sim import simulate_dataset as j_simulate
from duet_tpu.utils import chrom as j_chrom
from duet_tpu.utils import dispatch as j_dispatch
from duet_tpu.utils import devcost as j_devcost
from duet_tpu_torch import cli as t_cli
from duet_tpu_torch import pipeline as t_pipeline
from duet_tpu_torch.io import readstore as t_readstore
from duet_tpu_torch.io import vcf as t_vcf
from duet_tpu_torch.models import decision_model as t_decision
from duet_tpu_torch.models import nn_snp_host as t_nn
from duet_tpu_torch.models import snp_caller_host as t_snp
from duet_tpu_torch.models import snp_phaser as t_phaser_dev
from duet_tpu_torch.models import snp_phaser_host as t_phaser
from duet_tpu_torch.models import sv_caller as t_sv_dev
from duet_tpu_torch.models import sv_caller_host as t_sv
from duet_tpu_torch.models import sv_phaser as t_svp
from duet_tpu_torch.sim import SimConfig as TSimConfig
from duet_tpu_torch.sim import simulate_dataset as t_simulate
from duet_tpu_torch.utils import chrom as t_chrom
from duet_tpu_torch.utils import devcost as t_devcost
from duet_tpu_torch.utils import dispatch as t_dispatch

CONTIG = "chr21"


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _as(cls, obj):
    """`obj` (a duet_tpu dataclass) as the port's class `cls`."""
    return cls(**{f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(obj)})


def _same_fields(a, b):
    fa, fb = dataclasses.fields(a), dataclasses.fields(b)
    assert [f.name for f in fa] == [f.name for f in fb]
    for f in fa:
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
            assert x.dtype == y.dtype, f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("seed", [3, 8])
def test_simulator_writes_duet_tpus_bytes(tmp_path, seed):
    kw = dict(contigs={"chr1": 60_000, "chr2": 40_000}, seed=seed,
              coverage=8.0, read_len_mean=6_000, tra_count=1,
              inv_fraction=0.2, dup_fraction=0.2)
    j_simulate(str(tmp_path / "jax"), JSimConfig(**kw))
    t_simulate(str(tmp_path / "torch"), TSimConfig(**kw))
    for name in ("reads.bam", "reads.bam.bai", "ref.fa", "ref.fa.fai",
                 "truth.vcf"):
        assert _bytes(tmp_path / "torch" / name) == \
            _bytes(tmp_path / "jax" / name), name


@pytest.mark.parametrize("reader", ["python", "native"])
def test_read_store_equal(sim_dataset, reader):
    from duet_tpu.io import native_ingest as j_native
    from duet_tpu_torch.io import native_ingest as t_native

    bam = os.path.join(sim_dataset[0], "reads.bam")
    if reader == "python":
        want, got = j_readstore.load_read_store(bam), \
            t_readstore.load_read_store(bam)
    else:
        want, got = j_native.load_read_store_native(bam), \
            t_native.load_read_store_native(bam)
    assert got.contig_lengths == want.contig_lengths
    assert list(got.contigs) == list(want.contigs)
    for c in want.contigs:
        _same_fields(got.contigs[c], want.contigs[c])


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the places where the port's ingest source may differ from
# native/duet_ingest.cc: the inflate library's include, inflate_block with
# the comment above it, the inflate worker of the thread pool, the module
# the header names as the C API's consumer; and, in the port's source
# alone, its inflater route (duet_bam_set_inflater): the API line, the
# inflater's type, the reader's fields for it, the helpers before refill,
# the comment lines refill adds, the header's member-at-a-time line and
# the batch-full check in its member scan, the branch that hands the
# members to the inflater, and the setter; and the API lines of
# duet_bam_release and duet_bam_held_bytes and the two functions with
# their comments.  The rest of refill (the reclaim, the member scan, the
# zlib pool, the file read) stays the shared source's.
OWN_REGIONS = (
    (r"#include <(libdeflate|zlib)\.h>\n", "<include>\n", True),
    (r"(//[^\n]*\n)+bool inflate_block\(.*?\n}\n", "<inflate_block>\n",
     True),
    (r"pool\.emplace_back\(\[&, t\]\(\) \{\n.*?\n {8}\}\);\n",
     "<worker>\n", True),
    (r"consumed via ctypes from duet_tpu(_torch)?/io/native_ingest\.py",
     "<consumer>", True),
    (r"//   duet_bam_set_inflater\(.*?\n(?=//   duet_bam_next_contig)", "",
     False),
    (r"\n(//[^\n]*\n)+typedef int \(\*InflateFn\)\(.*?\);\n", "", False),
    (r"  // the batch inflater, .*?added_members = 0;\n\n", "", False),
    (r"// The inflater's route \(duet_bam_set_inflater\), refill's steps.*?"
     r"\n}\n\n(?=// Read more compressed bytes)", "", False),
    (r"// With an inflater set, past the header .*?\n(?=bool refill)", "",
     False),
    (r"      if \(!rd->header_done && out_off > out_base\) break;[^\n]*\n", "",
     False),
    (r"      if \(batch_full\(.*?\n        break;\n", "", False),
    (r"    if \(rd->inflater && rd->header_done\) \{\n.*?\n    \} else\n", "",
     False),
    (r"(//[^\n]*\n)+void duet_bam_set_inflater\(.*?\n}\n\n", "", False),
    (r"//   duet_bam_release / duet_bam_held_bytes\n//     [^\n]*\n", "",
     False),
    (r"(//[^\n]*\n)+void duet_bam_release\(void\* h\) \{\n.*?\n}\n\n"
     r"(//[^\n]*\n)+int64_t duet_bam_held_bytes\(void\* h\) \{\n.*?\n}\n\n",
     "", False),
)


def _outside_own_regions(text, port=True):
    """The source with the regions it may differ in replaced by marks;
    `port` is whether it is the port's (which alone has some of them)."""
    import re

    for pattern, mark, shared in OWN_REGIONS:
        text, n = re.subn(pattern, mark, text, flags=re.S)
        assert n == (1 if port or shared else 0), pattern
    return text


def _sources():
    with open(os.path.join(REPO, "native", "duet_ingest.cc")) as f:
        want = f.read()
    with open(os.path.join(REPO, "duet_tpu_torch", "csrc",
                           "duet_ingest.cc")) as f:
        got = f.read()
    return got, want


def test_ingest_source_is_the_shared_one_but_for_its_inflate():
    got, want = _sources()
    assert got != want
    assert _outside_own_regions(got) == \
        _outside_own_regions(want, port=False)


@pytest.mark.parametrize("where,allowed", [
    ("mremap(raw.p, raw.cap, keep, 0)", True),   # inside duet_bam_release
    ("c.flag.capacity() * 2", True),             # inside duet_bam_held_bytes
    ("inflateReset(zs)", True),                  # inside inflate_block
    ("batch_step(rd, members, off, out_base)", True),  # the inflater's
    ("rd->added_in += off - rd->comp_head;", True),    # inside batch_step
    ("rd->error = \"invalid BGZF stream\";", False),   # refill's scan
    ("nt = static_cast<int>(members.size());", False),  # refill's pool
    ("if (rd->file_eof) return false;", False),        # refill's read
    ("rd->metas.clear();", False),               # decode_columns
    ("rd->retain = rd->scan_pos;", False),       # duet_bam_next_contig
    ("constexpr size_t kReadChunk", False),      # a constant
    ("duet_bam_fill / duet_bam_stats", False),   # not in the source: added
])
def test_ingest_pin_fails_on_any_other_edit(where, allowed):
    """An edit inside a named region keeps the pin; one anywhere else in
    the port's ingest source breaks it."""
    got, want = _sources()
    if where in got:
        edited = got.replace(where, where + " ", 1)
    else:
        edited = got.replace("//   duet_bam_n_refs", "//   " + where +
                             "\n//   duet_bam_n_refs", 1)
    assert edited != got
    same = _outside_own_regions(edited) == \
        _outside_own_regions(want, port=False)
    assert same == allowed


def test_ingest_build_names_no_libdeflate():
    from duet_tpu_torch.io import native_ingest as t_native

    with open(t_native._SRC) as f:
        src = f.read()
    assert t_native._SRC == os.path.join(REPO, "duet_tpu_torch", "csrc",
                                         "duet_ingest.cc")
    assert "deflate" not in src.lower().replace("inflate", "")
    assert "#include <zlib.h>" in src
    assert not [f for f in t_native._LDFLAGS if "deflate" in f]
    assert "-lz" in t_native._LDFLAGS


def _first_member(data: bytes) -> tuple[int, int]:
    """(header length, BSIZE) of the BGZF member at the start of data."""
    import struct

    xlen = struct.unpack("<H", data[10:12])[0]
    return 12 + xlen, struct.unpack("<H", data[16:18])[0] + 1


@pytest.mark.parametrize("where", ["magic", "deflate", "crc32", "isize"])
def test_native_ingest_rejects_a_corrupt_member(sim_dataset, tmp_path, where):
    """A BAM whose first BGZF member is corrupt fails in both packages'
    native readers, with the reader's BGZF errors: the zlib inflate keeps
    the gzip trailer's CRC32 and ISIZE checks."""
    from duet_tpu.io import native_ingest as j_native
    from duet_tpu_torch.io import native_ingest as t_native

    with open(os.path.join(sim_dataset[0], "reads.bam"), "rb") as f:
        data = bytearray(f.read())
    head, bsize = _first_member(data)
    at = {"magic": 0, "deflate": head + (bsize - 8 - head) // 2,
          "crc32": bsize - 8, "isize": bsize - 4}[where]
    data[at] ^= 0x5A
    bad = tmp_path / "bad.bam"
    bad.write_bytes(bytes(data))
    for native in (j_native, t_native):
        with pytest.raises(ValueError,
                           match="invalid BGZF stream|BGZF inflate failed"):
            native.load_read_store_native(str(bad))


@pytest.fixture(scope="module")
def stage_objects(sim_dataset):
    """duet_tpu's host stage objects on the shared dataset, and the port's
    from its own store: SNPs, SV calls and breakends, phasing."""
    from duet_tpu.io.fasta import FastaFile

    data = sim_dataset[0]
    bam = os.path.join(data, "reads.bam")
    j_store = j_readstore.load_read_store(bam)
    t_store = t_readstore.load_read_store(bam)
    codes = {CONTIG: FastaFile(os.path.join(data, "ref.fa")).fetch_codes(
        CONTIG)}
    j_snps, _ = j_snp.call_snps_for_store(j_store, codes)
    sv_cfg = j_sv.SvCallConfig()
    j_calls, j_ev = j_sv.call_contig_with_evidence(j_store.contigs[CONTIG],
                                                   sv_cfg)
    t_calls, t_ev = t_sv_dev.call_contig_with_evidence(
        t_store.contigs[CONTIG], t_sv.SvCallConfig())
    j_phase = j_phaser.phase_contig(j_store.contigs[CONTIG], j_snps[CONTIG])
    t_snps = _as(t_snp.ContigSnps, j_snps[CONTIG])
    core = t_phaser_dev.phase_contig_core(t_store.contigs[CONTIG], t_snps)
    t_phase = t_phaser_dev.score_contigs_batched({CONTIG: core}, False,
                                                 0)[CONTIG]
    return dict(j_store=j_store, t_store=t_store, j_snps=j_snps,
                j_calls=j_calls, t_calls=t_calls,
                j_bnds=j_sv.call_bnds({CONTIG: j_ev}, sv_cfg),
                t_bnds=t_sv.call_bnds({CONTIG: t_ev}, t_sv.SvCallConfig()),
                j_phase=j_phase, t_phase=t_phase)


def test_stage_objects_equal(stage_objects):
    o = stage_objects
    assert len(o["t_calls"]) == len(o["j_calls"]) > 0
    for a, b in zip(o["t_calls"], o["j_calls"]):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert [dataclasses.astuple(b) for b in o["t_bnds"]] == \
        [dataclasses.astuple(b) for b in o["j_bnds"]]
    _same_fields(o["t_phase"], o["j_phase"])


def test_pileup_vcf_writer(stage_objects, tmp_path):
    o = stage_objects
    lengths = o["j_store"].contig_lengths
    j_snp.write_pileup_vcf(str(tmp_path / "j.vcf.gz"), o["j_snps"], lengths)
    t_snp.write_pileup_vcf(str(tmp_path / "t.vcf.gz"),
                           {c: _as(t_snp.ContigSnps, s)
                            for c, s in o["j_snps"].items()}, lengths)
    assert _bytes(tmp_path / "t.vcf.gz") == _bytes(tmp_path / "j.vcf.gz")
    assert t_vcf.list_chroms(str(tmp_path / "j.vcf.gz")) == \
        j_vcf.list_chroms(str(tmp_path / "j.vcf.gz"))


@pytest.mark.parametrize("family", ["cutesv", "sniffles", "svim"])
def test_sv_vcf_writer_and_parser(stage_objects, tmp_path, family):
    o = stage_objects
    lengths = o["j_store"].contig_lengths
    want = str(tmp_path / "j.vcf")
    got = str(tmp_path / "t.vcf")
    j_sv.write_sv_vcf(want, {CONTIG: o["j_calls"]}, lengths, family=family,
                      bnds=o["j_bnds"])
    t_sv.write_sv_vcf(got, {CONTIG: [_as(t_sv.SvCall, c)
                                     for c in o["j_calls"]]}, lengths,
                      family=family,
                      bnds=[_as(t_sv.BndCall, b) for b in o["j_bnds"]])
    assert _bytes(got) == _bytes(want)
    # the port's parser reads duet_tpu's file into the same records
    for include_all in (False, True):
        j_rec = j_vcf.parse_sv_vcf(want, include_all)
        t_rec = t_vcf.parse_sv_vcf(want, include_all)
        assert list(t_rec) == list(j_rec)
        for c in j_rec:
            assert [dataclasses.astuple(r) for r in t_rec[c]] == \
                [dataclasses.astuple(r) for r in j_rec[c]]
    assert t_vcf.read_vcf_lines(want) == j_vcf.read_vcf_lines(want)


def test_phased_snp_vcf_writer(stage_objects, tmp_path):
    o = stage_objects
    snps = o["j_snps"][CONTIG]
    j_phaser.write_phased_snp_vcf(str(tmp_path / "j.vcf.gz"), CONTIG, snps,
                                  o["j_phase"])
    t_phaser.write_phased_snp_vcf(str(tmp_path / "t.vcf.gz"), CONTIG,
                                  _as(t_snp.ContigSnps, snps),
                                  _as(t_phaser.PhaseResult, o["j_phase"]))
    assert _bytes(tmp_path / "t.vcf.gz") == _bytes(tmp_path / "j.vcf.gz")
    with gzip.open(tmp_path / "j.vcf.gz", "rt") as f:
        assert any(not ln.startswith("#") for ln in f)


def test_phased_sv_vcf_writer(stage_objects, tmp_path):
    """variants.vcf -> parse -> phase -> phased_sv.vcf with each package's
    own functions: the same bytes."""
    o = stage_objects
    lengths = o["j_store"].contig_lengths
    variants = str(tmp_path / "variants.vcf")
    j_sv.write_sv_vcf(variants, {CONTIG: o["j_calls"]}, lengths,
                      bnds=o["j_bnds"])
    read_hap = j_phaser.read_hap_map(o["j_store"].contigs[CONTIG],
                                     o["j_phase"])
    assert t_phaser.read_hap_map(o["t_store"].contigs[CONTIG],
                                 o["t_phase"]) == read_hap
    for pkg, vcf, svp in (("j", j_vcf, j_svp), ("t", t_vcf, t_svp)):
        out = str(tmp_path / f"{pkg}_phased.vcf")
        records = vcf.parse_sv_vcf(variants, False)
        phased = svp.phase_callset(records, {CONTIG: read_hap}, 50, 2)
        vcf.write_phased_sv_header(variants, out, False)
        vcf.append_phased_sv_records(phased, out)
    assert _bytes(tmp_path / "t_phased.vcf") == \
        _bytes(tmp_path / "j_phased.vcf")


CONSTANTS = [
    (j_snp, t_snp, ("BASES", "DEVICE_PILEUP_WINDOW",
                    "DEVICE_MAX_SITE_DENSITY", "AUTO_NN_MIN_COV",
                    "AUTO_NN_MIN_ERR")),
    (j_phaser, t_phaser, ("HAPLOTAG_B", "HAPLOTAG_BATCH",
                          "REFINE_CORRECT_ROUNDS", "PC_PER_MARGIN", "PC_MAX",
                          "ADAPTIVE_N1", "ADAPTIVE_REL", "ADAPTIVE_RHO")),
    (j_sv, t_sv, ("SVTYPE_INS", "SVTYPE_DEL", "SVTYPE_INV", "SVTYPE_DUP",
                  "TYPE_NAMES")),
    (j_svp, t_svp, ("HP_STRINGS",)),
    (j_nn, t_nn, ("N_FEATURES", "HIDDEN", "N_CLASSES", "HALF_WINDOW",
                  "N_WINDOW")),
    (j_dispatch, t_dispatch, ("STAGES",)),
    (j_devcost, t_devcost, ("_FIELDS",)),
    # named deviations: auto's gates are the port's own, measured on the
    # H100 (route_crossover, PERF.md §5), where duet_tpu's are its TPU
    # fast-link values — (duet_tpu's name, the port's name, port's value)
    (j_pipeline.PipelineConfig, t_pipeline.PipelineConfig,
     (("PHASING_GATE_FAST_NNZ", "PHASING_GATE_H100_NNZ", 49_995),
      ("SV_GATE_FAST_K", "SV_GATE_H100_K", 64_000))),
]


@pytest.mark.parametrize("j_mod,t_mod,names", CONSTANTS,
                         ids=[c[1].__name__ for c in CONSTANTS])
def test_module_constants_equal(j_mod, t_mod, names):
    for name in names:
        if isinstance(name, tuple):
            j_name, t_name, value = name
            assert getattr(t_mod, t_name) == value, t_name
            assert getattr(j_mod, j_name) != value, j_name
        else:
            assert getattr(t_mod, name) == getattr(j_mod, name), name


def test_haplotag_device_mode_is_the_ports_own():
    """The scorer is the port's own choice: auto's is the one that was
    faster past the phasing gate on the H100 (the sparse COO scatter, as
    duet_tpu's), and --device-stages on forces the dense route of the hand
    kernel."""
    assert j_phaser.HAPLOTAG_DEVICE_MODE == "sparse"
    assert t_phaser_dev.HAPLOTAG_DEVICE_MODE == "sparse"
    paths = dict(bam="x.bam", reference="x.fa", output="out")
    assert t_pipeline.PipelineConfig(device_stages="on", **paths
                                     ).haplotag_mode() == "dense"
    for stages in ("auto", "off"):
        assert t_pipeline.PipelineConfig(device_stages=stages, **paths
                                         ).haplotag_mode() == "sparse"


@pytest.mark.parametrize("j_cls,t_cls", [
    (j_snp.SnpCallConfig, t_snp.SnpCallConfig),
    (j_sv.SvCallConfig, t_sv.SvCallConfig),
    (j_pipeline.PipelineConfig, t_pipeline.PipelineConfig),
], ids=["SnpCallConfig", "SvCallConfig", "PipelineConfig"])
def test_config_fields_and_defaults_equal(j_cls, t_cls):
    def spec(cls):
        return [(f.name, f.default, f.default_factory)
                for f in dataclasses.fields(cls) if f.name != "device"
                or cls is not t_pipeline.PipelineConfig]
    assert spec(t_cls) == spec(j_cls)


def test_pipeline_config_methods_agree():
    """The configs agree under on.  Under auto and off the size gates are
    the named deviation (read under off only to be recorded): the port's
    are the H100's, duet_tpu's its TPU fast-link values."""
    paths = dict(bam="x.bam", reference="x.fa", output="out")
    for stages in ("auto", "on", "off"):
        j = j_pipeline.PipelineConfig(device_stages=stages, **paths)
        t = t_pipeline.PipelineConfig(device_stages=stages, device="cpu",
                                      **paths)
        assert dataclasses.asdict(t.snp_cfg()) == \
            dataclasses.asdict(j.snp_cfg())
        t_sv, j_sv = dataclasses.asdict(t.sv_cfg()), \
            dataclasses.asdict(j.sv_cfg())
        if stages == "on":
            assert t_sv == j_sv
            assert t.phasing_device_min_nnz() == j.phasing_device_min_nnz()
            continue
        assert t_sv.pop("device_min_k") == 64_000 != j_sv.pop("device_min_k")
        assert t_sv == j_sv
        assert t.phasing_device_min_nnz() == 49_995 != \
            j.phasing_device_min_nnz()
    # auto on a card: the decision pass stays on the host (its device
    # route never beat the host's outside its spread on the H100); the
    # pileup of the counting rule goes to the device from its gates, a
    # named deviation (duet_tpu's auto keeps it on the host), and under
    # --snp-model auto stays on the host; on forces both
    gpu = t_pipeline.PipelineConfig(device_stages="auto", device="cuda",
                                    snp_model="counts", **paths)
    assert gpu.DECIDE_GATE_H100_CALLS is None
    assert not gpu.decide_on_device(10 ** 9)
    assert gpu.PILEUP_GATE_H100_BASES == 41_494_548
    assert gpu.PILEUP_CONTIG_GATE_H100_BASES == 20_735_789
    assert not hasattr(j_pipeline.PipelineConfig, "PILEUP_GATE_H100_BASES")
    assert not gpu.pileup_on_device(41_494_547)
    assert gpu.pileup_on_device(41_494_548) and gpu.pileup_on_device()
    assert not gpu.pileup_on_device(20_735_788, stream=True)
    assert gpu.pileup_on_device(20_735_789, stream=True)
    for model in ("auto", "nn"):
        assert not dataclasses.replace(gpu, snp_model=model
                                       ).pileup_on_device(10 ** 12)
    assert not j_pipeline.PipelineConfig(device_stages="auto",
                                         snp_model="counts", **paths
                                         ).pileup_on_device()
    on = t_pipeline.PipelineConfig(device_stages="on", device="cuda", **paths)
    assert on.pileup_on_device(0) and on.decide_on_device(0)


def test_cli_flags_equal():
    """Every flag of duet-tpu, with its help text, but for the help of
    --profile and --coordinator, which name torch's profiler and
    torch.distributed where duet-tpu's name JAX's."""
    own_help = ("profile", "coordinator")

    def flags(parser):
        return [(a.dest, tuple(a.option_strings), a.default,
                 tuple(a.choices or ()),
                 None if a.dest in own_help else a.help)
                for a in parser._actions if a.dest != "help"]
    got = flags(t_cli.build_parser())
    want = flags(j_cli.build_parser())
    assert got[:-1] == want
    assert got[-1][:2] == ("device", ("--device",))
    helps = {a.dest: a.help for a in t_cli.build_parser()._actions}
    assert "torch.profiler" in helps["profile"]
    assert "torch.distributed" in helps["coordinator"]


def test_shipped_weights_equal():
    want, got = j_nn.load_params(), t_nn.load_params()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert t_decision.load_model() == j_decision.load_model()


class _Normalise(ast.NodeTransformer):
    """A module's AST with its imports dropped, ``duet_tpu_torch`` read as
    ``duet_tpu`` in strings, and the names in `renames` read as their
    duet_tpu counterparts."""

    def __init__(self, renames):
        self.renames = renames

    def visit_Import(self, node):
        return None

    visit_ImportFrom = visit_Import

    def visit_Name(self, node):
        node.id = self.renames.get(node.id, node.id)
        return node

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            node.value = node.value.replace("duet_tpu_torch", "duet_tpu")
        return node


def _top_level(path, renames=None):
    """[(name, ast.dump)] of a module's top-level statements, without its
    docstring and its imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    tree = _Normalise(renames or {}).visit(tree)
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant):
        body = body[1:]
    out = []
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            name = node.name
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            t = node.targets[0] if isinstance(node, ast.Assign) \
                else node.target
            name = t.id
        elif isinstance(node, ast.If):
            name = "__main__"
        else:
            name = type(node).__name__
        out.append((name, ast.dump(node)))
    return out


# the port's copies of whole duet_tpu modules: path under both packages ->
# (names read as duet_tpu's, top-level names whose code may differ, names
# only the port has).  The named deviations: --device (snp_grid's
# run_cell/main and its device call, haplotag_crossover's runners and
# their device, the port's clock that synchronises the card) and the
# patch target of pc_sweep and junction_sweep (the port's host phaser
# holds PC_PER_MARGIN and ADAPTIVE_N1).
MODULE_COPIES = {
    "eval/__init__.py": ({}, (), ()),
    "eval/evaluate.py": ({}, (), ()),
    "eval/reference_semantics.py": ({}, (), ()),
    "sim/cli_make_demo.py": ({}, (), ()),
    "tools/__init__.py": ({}, (), ()),
    "tools/merge.py": ({}, (), ()),
    "tools/view.py": ({}, (), ()),
    "tools/sweep.py": ({}, (), ()),
    "tools/pc_sweep.py": ({"snp_phaser_host": "snp_phaser"}, (), ()),
    "tools/junction_sweep.py": ({"snp_phaser_host": "snp_phaser"}, (), ()),
    "tools/junction_diag.py": ({}, (), ()),
    "tools/train_decision.py": ({}, (), ()),
    "tools/snp_grid.py": ({}, ("run_cell", "main"), ()),
    "tools/haplotag_crossover.py": ({}, ("run_multi", "main"), ("_clock",)),
}


@pytest.mark.parametrize("rel", list(MODULE_COPIES))
def test_module_copy_is_verbatim_but_for_its_named_deviations(rel):
    renames, differ, own = MODULE_COPIES[rel]
    want = _top_level(os.path.join(REPO, "duet_tpu", rel))
    got = [(n, d) for n, d in _top_level(
        os.path.join(REPO, "duet_tpu_torch", rel), renames) if n not in own]
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        if name in differ:
            assert g != w, f"{rel}: {name} no longer deviates"
        else:
            assert g == w, f"{rel}: {name} differs from duet_tpu's"


def test_nn_snp_host_functions_are_duet_tpus():
    """Every function of the port's nn_snp_host, the trainer's corpus
    builder and its helpers included, is duet_tpu's nn_snp function of
    that name but for imports."""
    want = dict(_top_level(os.path.join(REPO, "duet_tpu", "models",
                                        "nn_snp.py")))
    got = _top_level(os.path.join(REPO, "duet_tpu_torch", "models",
                                  "nn_snp_host.py"))
    names = [n for n, _ in got]
    for name in ("init_params", "apply_np", "save_params",
                 "_label_candidates", "build_training_set"):
        assert name in names
    for name, dump in got:
        assert dump == want[name], name


@pytest.mark.parametrize("name", ["chr7", "7", "chrUn_x", "X"])
def test_chrom_naming_equal(name):
    assert t_chrom.strip_chr(name) == j_chrom.strip_chr(name)
    for include in (False, True):
        assert t_chrom.resolve_contig_names([name, "chr1"], include) == \
            j_chrom.resolve_contig_names([name, "chr1"], include)
