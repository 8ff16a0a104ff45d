"""``duet_tpu.tools.train_decision``, copied for the port: verbatim but for its
imports.  sklearn is imported by ``main`` only (training time); the
pipelines run with ``use_device_kernel=False``, which never touches a
device.

Train the learned decision layer on simulation truth (VERDICT r2 #9).

Collects (feature, truth-class) rows from full pipeline runs across
coverages x seeds, fits a small CART (sklearn at TRAIN time only; the
runtime evaluator in models/decision_model.py is dependency-free JSON),
reports held-out e2e F1 head-to-head vs the verbatim T1-T5 tree, and
writes models/weights/decision_tree_v1.json.

    python -m duet_tpu_torch.tools.train_decision [--quick] [--out PATH]

Labels: each candidate call (post svlen/support filter, the exact set the
decision stage sees) matches truth by chrom+type+pos<=1000 nearest-unused;
matched -> {1 het, 2 hom} from the truth GT, unmatched -> 0 (filtered).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

from duet_tpu_torch.models.decision_model import (
    FEATURE_NAMES,
    FEATURE_SEMVER,
    feature_matrix,
)

# (coverage, seed, sub_error, artifacts): the clean grid, high-error cells,
# and ARTIFACT cells — spurious SV-sized insertions (random per-read +
# recurrent hotspots, sim.SimConfig artifact_*) are what real data has and
# what generates FALSE candidate calls, i.e. class-0 training rows, without
# which the tree never learns to filter (VERDICT r3 weak #1: the previous
# training callsets contained zero false positives).  Candidate collection
# runs at min_support_read=1 so single-read artifacts reach the decision
# stage as labeled rows.
TRAIN = [(cov, seed, 0.02, False) for cov in (8, 10, 12, 14, 20)
         for seed in (201, 202, 203)] + \
        [(cov, seed, 0.06, False) for cov in (8, 12, 20)
         for seed in (211, 212, 213)] + \
        [(cov, seed, 0.02, True) for cov in (8, 12, 20)
         for seed in (221, 222, 223)] + \
        [(cov, seed, 0.06, True) for cov in (8, 12, 20)
         for seed in (231, 232, 233, 234)]
# holdout groups need >=3 seeds each: the ship gate compares GROUP MEANS,
# and a single-seed group turns sim noise into a hard veto (round-5: the
# first ONT-model retrain was vetoed by two 1-seed groups)
HOLDOUT = [(cov, seed, 0.02, False) for cov in (8, 10, 12, 14, 20)
           for seed in (301, 302)] + \
          [(12, 311, 0.06, False), (8, 312, 0.06, False),
           (20, 313, 0.06, False), (10, 314, 0.06, False)] + \
          [(12, 321, 0.02, True), (8, 322, 0.02, True),
           (10, 325, 0.02, True)] + \
          [(20, 323, 0.06, True), (8, 324, 0.06, True),
           (12, 326, 0.06, True)]

# artifact intensity for `artifacts=True` cells (per 0.5 Mb contig).
# hotspots are the HARD class-0 rows: recurrent multi-read artifacts that
# survive the min-support filter and reach the decision stage at e2e time
# (single-read artifacts never do) — round-5 raised their density because
# the tree saw only ~70 such rows and leaked 64% of them
ART_INS_RATE = 0.08
ART_HOTSPOTS = 10


def collect_rows(data_dir: str, out_dir: str):
    """(X, y, out_dir ready) for one simulated dataset; the pipeline runs
    with the verbatim tree (the decision layer does not affect features)."""
    from duet_tpu_torch.eval.evaluate import (
        EvalEntry, _gt_class, evaluate_callsets, load_eval_vcf)
    from duet_tpu_torch.io.haplotag_bam import read_hap_tables_from_dir
    from duet_tpu_torch.models.sv_phaser_host import (
        attach_read_haplotypes, build_oneps_set, compute_features,
        distinct_ps_regime, pack_calls)
    from duet_tpu_torch.pipeline import (
        PipelineConfig, parse_sv_vcf, run_pipeline)
    from duet_tpu_torch.utils.chrom import strip_chr

    # min_support_read=1: single-read artifact candidates must reach the
    # decision stage as class-0 training rows (the default filter would
    # remove them before any features exist to learn from)
    run_pipeline(PipelineConfig(
        bam=os.path.join(data_dir, "reads.bam"),
        reference=os.path.join(data_dir, "ref.fa"),
        output=out_dir, use_device_kernel=False, min_support_read=1))
    per_chrom = parse_sv_vcf(
        os.path.join(out_dir, "sv_calling", "variants.vcf"), False)
    read_haps = read_hap_tables_from_dir(
        os.path.join(out_dir, "snp_phasing"), list(per_chrom))
    truth = load_eval_vcf(os.path.join(data_dir, "truth.vcf"))

    X_parts, y_parts = [], []
    for chrom, records in per_chrom.items():
        rh = read_haps.get(chrom, {})
        attach_read_haplotypes(records, rh)
        kept = [r for r in records
                if abs(r.svlen) >= 50 and r.support >= 1 and r.gt != "./."]
        if not kept:
            continue
        packed = pack_calls(kept)
        regime = distinct_ps_regime(packed)
        oneps = build_oneps_set(packed, np.ones(packed.n, bool), regime)
        if len(oneps) == 0:
            continue
        feats = compute_features(packed, regime, oneps)
        X = feature_matrix(feats, regime)
        calls = [EvalEntry(strip_chr(r.chrom), r.pos, r.svtype,
                           abs(r.svlen), "het", ".") for r in kept]
        res = evaluate_callsets(truth, calls)
        y = np.zeros(len(kept), dtype=np.int64)
        for ci, ti in res.matches:
            y[ci] = 1 if _gt_class(truth[ti].gt) == "het" else 2
        X_parts.append(X)
        y_parts.append(y)
    if not X_parts:
        return np.zeros((0, len(FEATURE_NAMES))), np.zeros(0, np.int64)
    return np.concatenate(X_parts), np.concatenate(y_parts)


def export_sklearn_tree(clf) -> dict:
    """sklearn tree_ -> the runtime's nested-dict JSON."""
    t = clf.tree_

    def node(i: int):
        if t.children_left[i] == -1:
            counts = t.value[i][0]
            return {"leaf": int(clf.classes_[int(np.argmax(counts))])}
        left = node(int(t.children_left[i]))
        right = node(int(t.children_right[i]))
        if left == right:
            # degenerate split (same prediction either way — happens when
            # impurity improves but the argmax class doesn't): collapse
            return left
        return {
            "feature": int(t.feature[i]),
            "threshold": float(t.threshold[i]),
            "left": left,
            "right": right,
        }

    return {"features": list(FEATURE_NAMES), "tree": node(0)}


def e2e_scores(data_dir: str, decision_model: str,
               model_path: str | None = None) -> dict:
    """Held-out end-to-end scores at the DEFAULT config (min_support 2 —
    recurrent hotspot artifacts survive that filter, so artifact cells are
    genuine FP-precision tests).  Reports f1 AND precision per axis.
    `model_path` points the learned evaluator at a freshly written tree
    (so `--out` runs evaluate what they trained, not the shipped file)."""
    from duet_tpu_torch.eval.evaluate import evaluate_files
    from duet_tpu_torch.models import decision_model as dm
    from duet_tpu_torch.pipeline import PipelineConfig, run_pipeline

    old_path = dm._MODEL_PATH
    if model_path is not None:
        dm._MODEL_PATH = os.path.abspath(model_path)
    try:
        with tempfile.TemporaryDirectory(prefix="dtrain_e2e_") as out:
            run_pipeline(PipelineConfig(
                bam=os.path.join(data_dir, "reads.bam"),
                reference=os.path.join(data_dir, "ref.fa"),
                output=out, use_device_kernel=False,
                decision_model=decision_model))
            s = evaluate_files(os.path.join(out, "phased_sv.vcf"),
                               os.path.join(data_dir, "truth.vcf")).summary()
    finally:
        dm._MODEL_PATH = old_path
    return {k: {"f1": s[k]["f1"], "precision": s[k]["precision"]}
            for k in ("calling", "genotyping", "phasing")}


def tree_stats(node: dict, depth: int = 0):
    """(max_depth, features_used, leaf_classes) of an exported tree."""
    if "leaf" in node:
        return depth, set(), {node["leaf"]}
    dl, fl, cl = tree_stats(node["left"], depth + 1)
    dr, fr, cr = tree_stats(node["right"], depth + 1)
    return max(dl, dr), {node["feature"]} | fl | fr, cl | cr


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    quick = "--quick" in argv
    out_path = (argv[argv.index("--out") + 1] if "--out" in argv else
                os.path.join(os.path.dirname(__file__), "..", "models",
                             "weights", "decision_tree_v1.json"))
    from sklearn.tree import DecisionTreeClassifier

    from duet_tpu_torch.sim.simulate import SimConfig, simulate_dataset

    train = TRAIN[:4] if quick else TRAIN
    holdout = HOLDOUT[:2] if quick else HOLDOUT
    mb = 0.25 if quick else 0.5

    # all simulated datasets live under one session dir so a run leaves
    # nothing behind (previously mkdtemp leaked ~33 BAM+FASTA dirs/run)
    data_root = tempfile.TemporaryDirectory(prefix="dtrain_data_")

    def dataset(cov, seed, err, art):
        d = tempfile.mkdtemp(prefix=f"{cov}_{seed}_", dir=data_root.name)
        simulate_dataset(d, SimConfig(
            contigs={"chr21": int(mb * 1e6)}, seed=seed, coverage=float(cov),
            sub_error=err,
            artifact_ins_rate=ART_INS_RATE if art else 0.0,
            artifact_hotspots=ART_HOTSPOTS if art else 0))
        return d

    # --rows PATH.npz: cache the collected (X, y) so hyperparameter
    # iterations skip the ~29 sim+pipeline collection runs; the cache is
    # keyed on the feature contract and refused when it changes
    rows_path = argv[argv.index("--rows") + 1] if "--rows" in argv else None
    X = y = None
    if rows_path and os.path.exists(rows_path):
        cached = np.load(rows_path, allow_pickle=True)
        cached_semver = int(cached["semver"]) if "semver" in cached else 0
        if list(cached["features"]) == list(FEATURE_NAMES) \
                and cached_semver == FEATURE_SEMVER:
            X, y = cached["X"], cached["y"]
        else:
            print(f"# rows cache {rows_path} has a stale feature contract; "
                  "recollecting", file=sys.stderr)
    if X is None:
        Xs, ys = [], []
        for cov, seed, err, art in train:
            d = dataset(cov, seed, err, art)
            with tempfile.TemporaryDirectory(prefix="dtrain_out_") as out:
                Xc, yc = collect_rows(d, out)
            Xs.append(Xc)
            ys.append(yc)
        X = np.concatenate(Xs)
        y = np.concatenate(ys)
        if rows_path:
            np.savez(rows_path, X=X, y=y,
                     features=np.array(FEATURE_NAMES, dtype=object),
                     semver=FEATURE_SEMVER)
    if not quick and int((y == 0).sum()) < 30:
        raise SystemExit(
            f"only {(y == 0).sum()} class-0 (filtered) rows collected — "
            "artifact cells failed to seed false candidates; refusing to "
            "ship a tree that cannot learn to filter")
    # balanced class weights: class-0 (filtered) rows are rarer than true
    # calls even with artifact cells — unweighted fits left class 0
    # unreachable in the exported tree
    # depth 6 / leaf 10 with SUPPORT-AWARE sample weights (round 5): rows
    # are collected at min-support 1, but at e2e time the pipeline's
    # default min-support-2 filter removes every single-read artifact
    # BEFORE the tree — so the rows that decide e2e precision are the
    # multi-read (hotspot) class-0 rows, a small minority of the class-0
    # pool.  Weight them 5x (class-0 base 2x): offline CV measured the
    # multi-read artifact leak drop 46/72 -> 19/72 at a 2% true-call
    # filtering cost; plain class_weight="balanced" optimizes the
    # single-read rows the e2e never sees.
    # inference clamps to the verbatim accept set (decision_model
    # .decide_haplotype_learned — precision-safe by construction), so the
    # tree's whole capacity goes to the rows where it can still act:
    # verbatim-ACCEPTED calls, which it may re-genotype or filter.
    vcol = X[:, FEATURE_NAMES.index("verbatim_class")]
    act = vcol > 0
    Xa, ya = X[act], y[act]
    svn_col = Xa[:, FEATURE_NAMES.index("sv_num")]
    w = np.ones(len(ya))
    w[ya == 0] = 2.0
    w[(ya == 0) & (svn_col >= 2)] = 3.0
    clf = DecisionTreeClassifier(max_depth=6, min_samples_leaf=10,
                                 random_state=0)
    clf.fit(Xa, ya, sample_weight=w)
    model = export_sklearn_tree(clf)
    depth, feats_used, leaf_classes = tree_stats(model["tree"])
    if not quick:
        # ship-bar (VERDICT r3 next #3): non-degenerate tree with a
        # reachable class-0 leaf and at least one magnitude/count feature
        magnitude = {FEATURE_NAMES.index(f) for f in
                     ("totsc_ratio", "onehap_totsc", "hap_avgsc_diff",
                      "totsc_min", "totsc_max", "ref_num", "sv_num",
                      "hap_min", "hap_max", "hap0", "allhap")}
        if depth < 2 or 0 not in leaf_classes or not (feats_used & magnitude):
            raise SystemExit(
                f"degenerate tree (depth={depth}, classes={leaf_classes}, "
                f"features={sorted(feats_used)}); not shipping")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    prev_model = None
    if os.path.exists(out_path):
        with open(out_path) as fh:
            prev_model = fh.read()
    with open(out_path, "w") as fh:
        json.dump(model, fh, indent=1)

    rows = []
    for cov, seed, err, art in holdout:
        d = dataset(cov, seed, err, art)
        rows.append({"cov": cov, "seed": seed, "err": err, "artifacts": art,
                     "verbatim": e2e_scores(d, "verbatim"),
                     "learned": e2e_scores(d, "learned",
                                           model_path=out_path)})
    # no-regression ship gate (VERDICT r4 next #5): per (error, artifact)
    # holdout group, mean learned calling F1 must stay within 0.01 of
    # verbatim AND mean precision must not regress on any axis — the
    # round-4 tree traded 0.046 calling recall at 6% error and shipped;
    # this refuses that trade
    # gated axes: calling F1 (the recall the round-4 tree traded away)
    # and calling/genotyping precision (the FP-filter wins that must
    # hold).  Phasing precision is NOT gated: holdout groups have 2-4
    # seeds with a handful of phased calls each, so one flipped call
    # moves the group mean several points — it is reported in the
    # holdout table for eyes, not vetoes.
    regressions = []
    groups: dict[tuple, list] = {}
    for r in rows:
        groups.setdefault((r["err"], r["artifacts"]), []).append(r)
    for key, grp in sorted(groups.items()):
        for axis in ("calling", "genotyping"):
            vf = float(np.mean([g["verbatim"][axis]["f1"] for g in grp]))
            lf = float(np.mean([g["learned"][axis]["f1"] for g in grp]))
            vp = float(np.mean([g["verbatim"][axis]["precision"]
                                for g in grp]))
            lp = float(np.mean([g["learned"][axis]["precision"]
                                for g in grp]))
            if axis == "calling" and lf < vf - 0.01:
                regressions.append(
                    f"group err={key[0]} art={key[1]}: calling F1 "
                    f"{lf:.4f} < verbatim {vf:.4f} - 0.01")
            if lp < vp - 0.01:
                regressions.append(
                    f"group err={key[0]} art={key[1]}: {axis} precision "
                    f"{lp:.4f} < verbatim {vp:.4f} - 0.01")
    if regressions and not quick:
        if prev_model is not None:
            with open(out_path, "w") as fh:
                fh.write(prev_model)
            outcome = "previous tree restored"
        else:
            # no previous model: the regressed tree must not linger at a
            # path later runs would load as if it had passed the gate
            os.remove(out_path)
            outcome = "no previous tree; output removed"
        print(json.dumps({"holdout": rows}, indent=2))
        raise SystemExit("holdout regression — model NOT shipped "
                         f"({outcome}):\n  " + "\n  ".join(regressions))
    print(json.dumps({
        "train_rows": int(len(y)),
        "class_counts": {int(c): int((y == c).sum()) for c in np.unique(y)},
        "tree_depth": depth,
        "tree_features": sorted(FEATURE_NAMES[i] for i in feats_used),
        "leaf_classes": sorted(leaf_classes),
        "model": out_path,
        "holdout": rows,
    }, indent=2))
    data_root.cleanup()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
