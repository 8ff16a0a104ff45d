"""Learned decision layer over the phasing feature block (flag-gated).

The verbatim T1-T5 tree (sv_phaser.decide_haplotype) is the parity
contract with the reference — its thresholds were trained on WhatsHap's
PC scale, and on framework data the magnitude gates (hap_avgsc_diff <=
1369.50/2400, totsc_ratio <= 9.72) are measured dead code
(docs/PC_SCALE.md): framework PCs are clipped and symmetric, so those
features never bind.  This module converts the dead features into
accuracy: a small CART refit ON FRAMEWORK FEATURES from simulation truth
(tools/train_decision.py), shipped as JSON and evaluated with a
dependency-free vectorized traversal.

Opt-in via `--decision-model learned`; the default pipeline path and all
reference-parity tests keep the verbatim tree.  The learned model
predicts the GT CLASS only {0 filtered, 1 het, 2 hom} — deliberately
side-symmetric — and the het SIDE (1|0 vs 0|1) comes from the evidence
direction exactly as the verbatim tree chooses it (larger per-haplotype
PC mass, avgsc when only one side has evidence).
"""

from __future__ import annotations

import json
import os

import numpy as np

# side-symmetric feature vector (order is the serialized contract).  The
# two ctx_* columns are PER-CHROMOSOME context broadcast to every call:
# under heavy read error sv_ratio is GLOBALLY depressed (every call's
# support reads carry mismatches), and a per-call threshold that is right
# at 2% error filters true calls at 6% — the round-4 holdout lost 0.046
# calling F1 exactly that way (docs/PC_SCALE.md).  The chromosome-median
# sv_ratio and depth let the tree condition its filter on the regime the
# data is actually in, with no cross-stage plumbing (both are medians
# over the candidate block the decision stage already holds).
FEATURE_NAMES = (
    "regime", "sv_ratio", "hapread_ratio", "totsc_ratio", "onehap_totsc",
    "hap_avgsc_diff", "hap_min", "hap_max", "hap0", "allhap",
    "totsc_min", "totsc_max", "ref_num", "sv_num",
    "ctx_sv_ratio_med", "ctx_depth_med", "sv_ratio_rel",
    "verbatim_class",
)

# bump when a feature's MEANING changes without its name changing (e.g.
# the ctx_* median population fix) — the trainer's --rows cache and any
# other serialized feature matrix must key on this, not just the names
FEATURE_SEMVER = 2

_MODEL_PATH = os.path.join(os.path.dirname(__file__), "weights",
                           "decision_tree_v1.json")


def feature_matrix(f, regime: np.ndarray) -> np.ndarray:
    """(n, len(FEATURE_NAMES)) float64 from a PhaseFeatures block.

    The block is one chromosome's candidate calls, so the ctx_* medians
    computed here ARE the per-chromosome context features.  Medians run
    over the sv_num >= 2 SUBPOPULATION: training collects candidate
    blocks at min-support 1 (to harvest filtered-class rows) while the
    default pipeline filters to support >= 2 before the decision stage —
    taking the median over all rows would fit thresholds against
    single-read-artifact-depressed statistics that inference never sees
    (train/serve skew).  The >= 2 subpopulation is the same population
    in both regimes."""
    n = len(f.sv_ratio)
    depth = f.ref_num + f.sv_num
    multi = f.sv_num >= 2
    ratio_pop = f.sv_ratio[multi] if multi.any() else f.sv_ratio
    depth_pop = depth[multi] if multi.any() else depth
    ctx_ratio = np.full(n, np.median(ratio_pop) if n else 0.0)
    ctx_depth = np.full(n, np.median(depth_pop) if n else 0.0)
    # regime-RELATIVE support ratio: one axis-aligned cut on this feature
    # is "filter calls whose support ratio sits well below the
    # chromosome's norm", valid across error regimes — a hotspot artifact
    # at sv_ratio ~0.3 scores ~0.6 of the contig median whether the data
    # is clean (med ~0.5) or error-depressed (med ~0.45), while true
    # calls sit near 1.0.  The raw (sv_ratio, ctx) pair needs a 2D split
    # the tree's axis-aligned cuts model poorly.
    rel = f.sv_ratio / np.maximum(ctx_ratio, 0.05)
    # STACKED feature: the verbatim T1-T5 tree's own class for this call
    # ({0 filtered, 1 het, 2 hom}).  With this column the learned tree can
    # reproduce reference behavior with a single split and only DEVIATES
    # where training data shows an impurity gain — "at least as good as
    # verbatim" becomes the model's floor rather than a hope.
    from duet_tpu_torch.models.sv_phaser import decide_haplotype

    vpred = decide_haplotype(f, regime)
    vclass = np.where(vpred == 3, 2, np.where(vpred > 0, 1, 0))
    return np.stack([
        regime.astype(np.float64),
        f.sv_ratio, f.hapread_ratio, f.totsc_ratio, f.onehap_totsc,
        f.hap_avgsc_diff,
        np.minimum(f.hap1, f.hap2), np.maximum(f.hap1, f.hap2),
        f.hap0, f.allhap,
        np.minimum(f.hap1_totsc, f.hap2_totsc),
        np.maximum(f.hap1_totsc, f.hap2_totsc),
        f.ref_num, f.sv_num,
        ctx_ratio, ctx_depth, rel,
        vclass.astype(np.float64),
    ], axis=1)


_MODEL_CACHE: dict[str, tuple[tuple[int, int], dict]] = {}


def load_model(path: str | None = None) -> dict:
    """Parse + validate the tree JSON once per file generation — the
    decision stage calls this per chromosome, and a retrain-then-evaluate
    loop that rewrites the JSON in-process must see the new tree, not a
    stale cache entry.  The generation key is (st_mtime_ns, st_size):
    nanosecond mtime plus size distinguishes same-second rewrites on
    coarse-timestamp filesystems, where float getmtime could not.  One
    entry per path (stale generations of the SAME path are evicted;
    alternating two model paths stays cached for both).  Returns a deep
    copy so caller mutation cannot poison the cache (the model is a tiny
    dict)."""
    import copy

    real = os.path.realpath(path or _MODEL_PATH)
    stt = os.stat(real)
    gen = (stt.st_mtime_ns, stt.st_size)
    hit = _MODEL_CACHE.get(real)
    if hit is None or hit[0] != gen:
        with open(real) as fh:
            model = json.load(fh)
        if model.get("features") != list(FEATURE_NAMES):
            raise ValueError("decision model feature contract mismatch")
        _MODEL_CACHE[real] = (gen, model)
        hit = _MODEL_CACHE[real]
    return copy.deepcopy(hit[1])


def _eval_tree(node: dict, X: np.ndarray, out: np.ndarray,
               mask: np.ndarray) -> None:
    if not mask.any():
        return
    if "leaf" in node:
        out[mask] = node["leaf"]
        return
    go_left = X[:, node["feature"]] <= node["threshold"]
    _eval_tree(node["left"], X, out, mask & go_left)
    _eval_tree(node["right"], X, out, mask & ~go_left)


def predict_class(model: dict, X: np.ndarray) -> np.ndarray:
    """Vectorized traversal: per-row class in {0 filtered, 1 het, 2 hom}."""
    out = np.zeros(len(X), dtype=np.int64)
    _eval_tree(model["tree"], X, out, np.ones(len(X), dtype=bool))
    return out


def decide_haplotype_learned(f, regime: np.ndarray,
                             model: dict | None = None) -> np.ndarray:
    """Drop-in for sv_phaser.decide_haplotype: 0 filtered, 1 '1|0',
    2 '0|1', 3 '1|1'.  Class from the learned tree; het side from the
    evidence direction (the verbatim tree's own side rules).

    PRECISION-SAFE BY CONSTRUCTION: the learned layer may FILTER calls
    the verbatim tree accepts and re-GENOTYPE accepted calls, but never
    un-filters a verbatim rejection.  A tree trained to rescue
    verbatim-filtered calls keyed the rescue on chromosome-aggregate
    features, and those aggregates shift with the very artifact density
    they are supposed to detect — measured on round-5 holdouts as
    accept-everything leaves that cost 0.10-0.24 calling precision on
    artifact cells (training-set CV looked clean each time; the ship gate
    vetoed four such trees).  Clamping to verbatim's accept set makes
    artifact precision >= verbatim's unconditionally, and the ask's
    recall bar is verbatim-parity, not verbatim-exceedance."""
    model = model or load_model()
    X = feature_matrix(f, regime)
    cls = predict_class(model, X)
    vclass = X[:, FEATURE_NAMES.index("verbatim_class")]
    cls = np.where(vclass == 0, 0, cls)
    # het side: larger PC mass wins; when only one side has evidence the
    # average-score side (verbatim regime-1 onehap rule) — identical here
    # since the massless side has avgsc 0 too
    side = np.where(f.hap1_totsc > f.hap2_totsc, 1,
                    np.where(f.hap2_totsc > f.hap1_totsc, 2,
                             np.where(f.hap1_avgsc > 0, 1, 2)))
    return np.where(cls == 1, side, np.where(cls == 2, 3, 0)).astype(np.int64)
