"""The port's evaluation harness, demo maker and tools against duet_tpu's,
on the CPU.  Each case runs the port's function and duet_tpu's on the same
simulated data and asserts equal results.

Tolerance: exact.  The timing fields of ``haplotag_crossover``'s rows
(``*_s``, ``*_speedup``, ``multi_vs_*``, the crossover sizes that follow
from them) and the output paths inside ``sweep``'s summary are left out of
the comparison; the swept VCFs themselves are compared byte for byte.

The tools' pipelines run with ``use_device_kernel=False``, which in the port
never touches a device, so they need no ``--device`` here.  ``pc_sweep``
and ``junction_sweep`` patch a constant of the port's host phaser
(``snp_phaser_host``): at 8x the PC scale changes final decisions, so
``pc_sweep``'s rows at scale 1 and 40 differ, as duet_tpu's do."""

import dataclasses
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from test_reference_eval_parity import _perturb, _records, write_vcf


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")


@pytest.fixture(scope="module")
def run(sim_dataset, tmp_path_factory):
    """The shared dataset and the port's host pipeline run on it."""
    from duet_tpu_torch.pipeline import PipelineConfig, run_pipeline

    data = sim_dataset[0]
    out = str(tmp_path_factory.mktemp("tools_run"))
    run_pipeline(PipelineConfig(
        bam=os.path.join(data, "reads.bam"),
        reference=os.path.join(data, "ref.fa"), output=out,
        use_device_kernel=False))
    return data, out


# ---------------------------------------------------------------- eval


@pytest.mark.parametrize("kw", [
    {}, {"refdist": 300, "pctsim": 0.7}, {"all_ctgs": True}, {"bed": True},
], ids=["default", "refdist_pctsim", "all_ctgs", "bed"])
def test_evaluate_files_summary_equal(run, tmp_path, kw):
    from duet_tpu.eval import evaluate as j_eval
    from duet_tpu_torch.eval import evaluate as t_eval

    data, out = run
    kw = dict(kw)
    if kw.pop("bed", False):
        bed = tmp_path / "win.bed"
        bed.write_text("chr21\t20000\t120000\n")
        kw["bed_path"] = str(bed)
    args = (os.path.join(out, "phased_sv.vcf"),
            os.path.join(data, "truth.vcf"))
    want = j_eval.evaluate_files(*args, **kw)
    got = t_eval.evaluate_files(*args, **kw)
    assert got.summary() == want.summary()
    assert got.matches == want.matches and got.per_type == want.per_type
    assert want.n_call > 0 and want.call_tp > 0


@pytest.mark.parametrize("flags", [
    [], ["--skip_phasing"], ["--reference-semantics"], ["-r", "200", "-a"],
], ids=["default", "skip_phasing", "reference_semantics", "refdist_all"])
def test_evaluate_main_prints_the_same(run, capsys, flags):
    from duet_tpu.eval import evaluate as j_eval
    from duet_tpu_torch.eval import evaluate as t_eval

    data, out = run
    argv = [os.path.join(out, "phased_sv.vcf"),
            os.path.join(data, "truth.vcf"), *flags]
    printed = []
    for mod in (j_eval, t_eval):
        assert mod.main(argv) == 0
        printed.append(capsys.readouterr().out)
    assert printed[1] == printed[0]
    json.loads(printed[0])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("skip_phasing", [False, True])
def test_reference_semantics_equal(tmp_path, seed, skip_phasing):
    """On the synthetic VCFs of tests/test_reference_eval_parity.py (DUP as
    INS, missing SVLEN, '.' alleles, unphased '1/1', polarity ties), with
    and without BED confinement."""
    from duet_tpu.eval import reference_semantics as j_ref
    from duet_tpu_torch.eval import reference_semantics as t_ref

    rng = np.random.default_rng(seed)
    truth, call = str(tmp_path / "truth.vcf"), str(tmp_path / "call.vcf")
    truth_recs = _records(rng, 60)
    write_vcf(truth_recs, truth)
    write_vcf(_perturb(rng, truth_recs), call)
    bed = str(tmp_path / "win.bed")
    with open(bed, "w") as f:
        f.write("chr1\t1000\t400000\nchr10\t50000\t800000\n")
    for path in (truth, call):
        for b in (None, bed):
            want = j_ref.parse_vcf_reference(path, skip_phasing, b)
            assert t_ref.parse_vcf_reference(path, skip_phasing, b) == want
    base = j_ref.parse_vcf_reference(truth, skip_phasing)
    calls = j_ref.parse_vcf_reference(call, skip_phasing)
    assert t_ref.evaluation_reference(base, calls, 1000, 0.0) == \
        j_ref.evaluation_reference(base, calls, 1000, 0.0)
    for b in (None, bed):
        want = j_ref.evaluate_files_reference(call, truth, 500, 0.5, b,
                                              skip_phasing)
        assert t_ref.evaluate_files_reference(call, truth, 500, 0.5, b,
                                              skip_phasing) == want
        assert want["calling"]["recall"] > 0 or b is not None


# ---------------------------------------------------------------- demo


def test_cli_make_demo_writes_duet_tpus_bytes(tmp_path, capsys):
    from duet_tpu.sim import cli_make_demo as j_demo
    from duet_tpu_torch.sim import cli_make_demo as t_demo

    argv = ["--length", "40000", "--coverage", "6", "--seed", "4",
            "--contig", "chr7"]
    assert j_demo.main([str(tmp_path / "j"), *argv]) == 0
    assert t_demo.main([str(tmp_path / "t"), *argv]) == 0
    for name in ("reads.bam", "reads.bam.bai", "ref.fa", "ref.fa.fai",
                 "truth.vcf"):
        assert _bytes(tmp_path / "t" / name) == _bytes(tmp_path / "j" / name)
    out = capsys.readouterr().out.splitlines()
    assert out[1] == out[0].replace(str(tmp_path / "j"), str(tmp_path / "t"))


# ---------------------------------------------------------------- merge, view


@pytest.mark.parametrize("names", [None, ["HG002", "HG003"]])
def test_merge_writes_the_same_bytes(run, tmp_path, names):
    from duet_tpu.tools import merge as j_merge
    from duet_tpu_torch.tools import merge as t_merge

    data, out = run
    vcfs = [os.path.join(out, "phased_sv.vcf"),
            os.path.join(data, "truth.vcf")]
    flags = ["-r", "500"] + (["--names", *names] if names else [])
    for pkg, mod in (("j", j_merge), ("t", t_merge)):
        assert mod.main([*vcfs, "-o", str(tmp_path / f"{pkg}.vcf"),
                         *flags]) == 0
    got = _bytes(tmp_path / "t.vcf")
    assert got == _bytes(tmp_path / "j.vcf")
    assert got.count(b"\n") > 10


@pytest.mark.parametrize("what,region", [
    ("bam", "chr21:10000-20000"), ("bam", "chr21:1-200000"),
    ("vcf", "chr21:1-100000"), ("vcf", "chr21:150,000-199,000"),
])
def test_view_prints_the_same(run, what, region):
    from duet_tpu.tools import view as j_view
    from duet_tpu_torch.tools import view as t_view

    data, out = run
    path = os.path.join(data, "reads.bam") if what == "bam" else \
        os.path.join(out, "snp_calling", "pileup.vcf.gz")
    fn = "view_bam" if what == "bam" else "view_vcf"
    sinks = [io.StringIO(), io.StringIO()]
    counts = [getattr(mod, fn)(path, region, out=sink)
              for mod, sink in zip((j_view, t_view), sinks)]
    assert counts[1] == counts[0] > 0
    assert sinks[1].getvalue() == sinks[0].getvalue()


@pytest.mark.parametrize("what,region,start", [
    ("bam", "chr21", 1), ("bam", "chr21:150000-", 150000),
    ("vcf", "chr21", 1), ("vcf", "chr21:100,000-", 100000),
])
def test_view_open_region_prints_the_bounded_one(run, sim_dataset, what,
                                                 region, start):
    """A region with no end: the port prints what duet_tpu prints for the
    region bounded at the contig's length (duet_tpu's own reg2bins would
    list every bin up to 2^60 for the open one)."""
    from duet_tpu.tools import view as j_view
    from duet_tpu_torch.tools import view as t_view

    data, out = run
    path = os.path.join(data, "reads.bam") if what == "bam" else \
        os.path.join(out, "snp_calling", "pileup.vcf.gz")
    fn = "view_bam" if what == "bam" else "view_vcf"
    bounded = f"chr21:{start}-{sim_dataset[1].contigs['chr21']}"
    sinks = [io.StringIO(), io.StringIO()]
    counts = [getattr(t_view, fn)(path, region, out=sinks[0]),
              getattr(j_view, fn)(path, bounded, out=sinks[1])]
    assert counts[0] == counts[1] > 0
    assert sinks[0].getvalue() == sinks[1].getvalue()


def test_view_count_main(run, capsys):
    from duet_tpu.tools import view as j_view
    from duet_tpu_torch.tools import view as t_view

    data, _ = run
    argv = ["-c", os.path.join(data, "reads.bam"), "chr21:5000-90000"]
    printed = []
    for mod in (j_view, t_view):
        assert mod.main(argv) == 0
        printed.append(capsys.readouterr().out)
    assert printed[1] == printed[0] and int(printed[0]) > 0


# ---------------------------------------------------------------- sweeps


def test_run_sweep_equal(run, tmp_path):
    from duet_tpu.tools import sweep as j_sweep
    from duet_tpu_torch.tools import sweep as t_sweep

    data, _ = run
    args = (os.path.join(data, "reads.bam"), os.path.join(data, "ref.fa"))
    kw = dict(values=[0.5, 0.9], truth=os.path.join(data, "truth.vcf"))
    want = j_sweep.run_sweep(*args, str(tmp_path / "j"), **kw)
    got = t_sweep.run_sweep(*args, str(tmp_path / "t"), **kw)
    for a, b in zip(got.pop("vcfs"), want.pop("vcfs")):
        assert _bytes(a) == _bytes(b)
    assert got == want and sum(want["n_calls"]) > 0
    with open(tmp_path / "t" / "sweep" / "sweep.json") as f:
        assert json.load(f)["n_calls"] == want["n_calls"]


def _haplotag_tables(out):
    d = os.path.join(out, "snp_phasing")
    return {n: _bytes(os.path.join(d, n)) for n in sorted(os.listdir(d))
            if n.endswith(".haplotags.tsv")}


def test_pc_sweep_patches_the_ports_host_scorer(tmp_path):
    """run_at_scale at scale 1 and 40 on an 8x dataset, where the PC scale
    changes final decisions: each scale's row and haplotag tables equal
    duet_tpu's, and the rows differ between the scales, so the patched
    constant reaches the port's scorer (a patch of models/snp_phaser.py
    would leave both rows alike)."""
    from duet_tpu.models import snp_phaser as j_phaser
    from duet_tpu.sim import SimConfig, simulate_dataset
    from duet_tpu.tools import pc_sweep as j_pc
    from duet_tpu_torch.models import snp_phaser_host as t_phaser
    from duet_tpu_torch.tools import pc_sweep as t_pc

    data = str(tmp_path / "data")
    simulate_dataset(data, SimConfig(contigs={"chr21": 150_000}, seed=40,
                                     coverage=8.0))
    rows, tables = {}, {}
    for scale in (1, 40):
        want = j_pc.run_at_scale(data, scale, str(tmp_path / f"j{scale}"))
        rows[scale] = t_pc.run_at_scale(data, scale,
                                        str(tmp_path / f"t{scale}"))
        assert rows[scale] == want and want["phased_calls"] > 0
        tables[scale] = _haplotag_tables(str(tmp_path / f"t{scale}"))
        assert tables[scale] == _haplotag_tables(str(tmp_path / f"j{scale}"))
    assert rows[1]["decisions"] != rows[40]["decisions"]
    assert tables[1] != tables[40]
    assert t_phaser.PC_PER_MARGIN == j_phaser.PC_PER_MARGIN == 10


@pytest.mark.parametrize("rule", ["adaptive", "adaptive_noN1"])
def test_junction_sweep_run_rule_equal(run, tmp_path, rule):
    from duet_tpu.tools import junction_sweep as j_js
    from duet_tpu_torch.models import snp_phaser_host as t_phaser
    from duet_tpu_torch.tools import junction_sweep as t_js

    data, _ = run
    want = j_js.run_rule(data, rule, str(tmp_path / "j"))
    got = t_js.run_rule(data, rule, str(tmp_path / "t"))
    assert got == want and want["calling"] > 0
    assert _haplotag_tables(str(tmp_path / "t")) == \
        _haplotag_tables(str(tmp_path / "j"))
    assert t_phaser.ADAPTIVE_N1 is True


def test_junction_diag_rows_equal(sim_dataset):
    from duet_tpu.tools import junction_diag as j_diag
    from duet_tpu_torch.tools import junction_diag as t_diag

    data, _, truth = sim_dataset
    want = j_diag.junction_rows(data, truth, 18.0, 7)
    got = t_diag.junction_rows(data, truth, 18.0, 7)
    assert got == want and len(want) > 0
    assert t_diag.summarize(got) == j_diag.summarize(want)


@pytest.fixture(scope="module")
def decision_rows(run, tmp_path_factory):
    from duet_tpu.tools import train_decision as j_td
    from duet_tpu_torch.tools import train_decision as t_td

    data, _ = run
    tmp = tmp_path_factory.mktemp("decision")
    want = j_td.collect_rows(data, str(tmp / "j"))
    got = t_td.collect_rows(data, str(tmp / "t"))
    return want, got


def test_train_decision_collect_rows_equal(decision_rows):
    (Xj, yj), (Xt, yt) = decision_rows
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(yt, yj)
    assert Xt.dtype == Xj.dtype and yt.dtype == yj.dtype
    assert len(yj) > 0


def test_train_decision_export_sklearn_tree_equal(decision_rows):
    from sklearn.tree import DecisionTreeClassifier

    from duet_tpu.tools import train_decision as j_td
    from duet_tpu_torch.tools import train_decision as t_td

    X, y = decision_rows[0]
    clf = DecisionTreeClassifier(max_depth=6, min_samples_leaf=2,
                                 random_state=0).fit(X, y)
    want = j_td.export_sklearn_tree(clf)
    assert t_td.export_sklearn_tree(clf) == want
    assert t_td.tree_stats(want["tree"]) == j_td.tree_stats(want["tree"])
    assert t_td.TRAIN == j_td.TRAIN and t_td.HOLDOUT == j_td.HOLDOUT


def test_train_decision_e2e_scores_equal(run, tmp_path):
    """The learned decision layer end to end, with the evaluator pointed at
    a copy of the shipped tree through decision_model._MODEL_PATH."""
    from duet_tpu.models import decision_model as j_dm
    from duet_tpu.tools import train_decision as j_td
    from duet_tpu_torch.models import decision_model as t_dm
    from duet_tpu_torch.tools import train_decision as t_td

    data, _ = run
    tree = str(tmp_path / "tree.json")
    shutil.copy(t_dm._MODEL_PATH, tree)
    paths = (j_dm._MODEL_PATH, t_dm._MODEL_PATH)
    want = j_td.e2e_scores(data, "learned", model_path=tree)
    got = t_td.e2e_scores(data, "learned", model_path=tree)
    assert got == want and want["calling"]["f1"] > 0
    assert (j_dm._MODEL_PATH, t_dm._MODEL_PATH) == paths


# ---------------------------------------------------------------- device tools


def test_snp_grid_run_cell_equal():
    from duet_tpu.tools import snp_grid as j_grid
    from duet_tpu_torch.tools import snp_grid as t_grid

    want = j_grid.run_cell(6.0, 0.02, 101)
    got = t_grid.run_cell(6.0, 0.02, 101, device=torch.device("cpu"))
    assert got == want
    assert want["nn"]["tp"] > 0 and want["counts"]["tp"] > 0


@pytest.mark.parametrize("nnz,seed", [(5000, 0), (20_000, 3), (9, 1)])
def test_haplotag_crossover_make_problem_equal(nnz, seed):
    from duet_tpu.tools import haplotag_crossover as j_hc
    from duet_tpu_torch.tools import haplotag_crossover as t_hc

    want = j_hc.make_problem(nnz, seed)
    got = t_hc.make_problem(nnz, seed)
    for f in dataclasses.fields(want[0]):
        a, b = getattr(got[0], f.name), getattr(want[0], f.name)
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


TIMING = ("_s", "_speedup", "multi_vs_host", "multi_vs_serial")


def _untimed(doc):
    rows = [{k: v for k, v in r.items() if not k.endswith(TIMING)}
            for r in doc["rows"]]
    return {k: v for k, v in doc.items()
            if k not in ("rows", "backend", "crossover_nnz",
                         "crossover_nnz_by_mode")} | {"rows": rows}


@pytest.mark.parametrize("argv", [["--sizes", "5"],
                                  ["--multi", "2,3", "--sizes", "5"]],
                         ids=["sizes", "multi"])
def test_haplotag_crossover_rows_equal(capsys, argv):
    from duet_tpu.tools import haplotag_crossover as j_hc
    from duet_tpu_torch.tools import haplotag_crossover as t_hc

    docs = []
    for mod, extra in ((j_hc, []), (t_hc, ["--device", "cpu"])):
        assert mod.main(argv + extra) == 0
        docs.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    assert _untimed(docs[1]) == _untimed(docs[0])
    assert docs[1]["backend"] == "cpu"
    keys = [sorted(r) for r in docs[0]["rows"]]
    assert [sorted(r) for r in docs[1]["rows"]] == keys
    if "--multi" not in argv:
        assert set(docs[1]["crossover_nnz_by_mode"]) == {"sparse", "dense"}


@pytest.mark.parametrize("tool", ["snp_grid", "haplotag_crossover"])
def test_device_tools_on_cuda_without_a_card_raise(tool, capsys):
    """--device cuda (the default) never carries on on the CPU."""
    import importlib

    _no_card()
    mod = importlib.import_module(f"duet_tpu_torch.tools.{tool}")
    for argv in (["--quick", "--sizes", "5"],
                 ["--quick", "--sizes", "5", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(argv)
    assert capsys.readouterr().out == ""
