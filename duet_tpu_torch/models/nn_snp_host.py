"""The host half of ``duet_tpu.models.nn_snp``, copied for the port.

The functions, classes and constants that the port's stage code uses, and
what they call, verbatim but for their imports.

Neural pileup SNP caller — the MXU counterpart of Clair3's pileup network.

The reference's SNP stage is Clair3 in pileup-only mode (reference
src/duet/snp_calling.py:13-17), i.e. a *neural network* over windowed pileup
count tensors, not a frequency rule.  This module provides the TPU-native
equivalent as an opt-in alternative to the exact-rational counting caller in
models/snp_caller.py: a small MLP over a 9-site pileup window, trained with
optax on the built-in simulator, with inference as one jitted f32 matmul
stack (MXU-friendly: the whole candidate set is classified in a single
batched forward pass).

Classes: 0 = non-variant, 1 = het, 2 = hom-alt.  The alt allele itself stays
the argmax non-reference allele, as in the counting caller, so downstream
stages see an identical ContigSnps contract.

Weights: duet_tpu/models/weights/nn_snp_v2.npz, reproducibly trained by
`python -m duet_tpu.models.nn_snp train <out.npz>` (fixed seeds, CPU-jax).
A numpy forward twin (`apply_np`) pins device/host decision parity in tests.

(In the port: the shipped weights are a copy of duet_tpu's, in
``duet_tpu_torch/models/weights/``; ``python -m duet_tpu_torch.models.nn_snp
train <out.npz>`` trains a new set on the card, ``models/nn_snp.py``.)
"""

from __future__ import annotations

import os

import numpy as np



HALF_WINDOW = 4                      # 9-site window, like a narrow Clair3 pileup

N_WINDOW = 2 * HALF_WINDOW + 1

N_FEATURES = N_WINDOW * 5 + 6        # 5 channels/site + ref onehot + altfrac + noisefrac

HIDDEN = 64

N_CLASSES = 3

DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "weights",
                               "nn_snp_v2.npz")

_PARAM_KEYS = ("W1", "b1", "W2", "b2", "W3", "b3")


def extract_features(counts: np.ndarray, ref_codes: np.ndarray,
                     cand_pos: np.ndarray, alt_code: np.ndarray) -> np.ndarray:
    """(n, N_FEATURES) float32 feature matrix for candidate sites.

    counts: (L, 4) allele counts (count_alleles output); ref_codes: (L,)
    uint8; cand_pos/alt_code: (n,) candidate positions and their argmax
    non-ref allele.  Windows are zero-padded at contig edges.  All channels
    are depth-normalized so the model is coverage-scale invariant, with one
    bounded absolute-depth channel per site.
    """
    n = len(cand_pos)
    if n == 0:
        return np.zeros((0, N_FEATURES), dtype=np.float32)
    L = counts.shape[0]
    pad = np.zeros((HALF_WINDOW, 4), dtype=counts.dtype)
    padded = np.concatenate([pad, counts, pad], axis=0).astype(np.float32)
    # (n, W, 4) windows around each candidate (offset by HALF_WINDOW padding)
    idx = cand_pos[:, None] + np.arange(N_WINDOW)[None, :]
    win = padded[idx]                                   # (n, W, 4)
    depth = win.sum(axis=2)                             # (n, W)
    safe = np.maximum(depth, 1.0)
    frac = win / safe[:, :, None]                       # (n, W, 4)
    depth_ch = np.minimum(depth, 100.0) / 100.0         # (n, W)
    site = np.concatenate([frac.reshape(n, -1), depth_ch], axis=1)

    ref = np.minimum(ref_codes[cand_pos], 3).astype(np.int64)
    onehot = np.zeros((n, 4), dtype=np.float32)
    onehot[np.arange(n), ref] = 1.0
    c = counts[cand_pos].astype(np.float32)             # (n, 4)
    cdepth = np.maximum(c.sum(axis=1), 1.0)
    alt_frac = c[np.arange(n), alt_code] / cdepth
    # strongest allele that is neither ref nor alt: a sequencing-noise /
    # multi-allelic indicator the frequency rule cannot see
    noise = c.copy()
    noise[np.arange(n), ref] = 0.0
    noise[np.arange(n), alt_code] = 0.0
    noise_frac = noise.max(axis=1) / cdepth
    return np.concatenate(
        [site, onehot, alt_frac[:, None], noise_frac[:, None]],
        axis=1).astype(np.float32)


def init_params(seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)

    def glorot(m, k):
        s = np.sqrt(6.0 / (m + k))
        return rng.uniform(-s, s, size=(m, k)).astype(np.float32)

    return {
        "W1": glorot(N_FEATURES, HIDDEN), "b1": np.zeros(HIDDEN, np.float32),
        "W2": glorot(HIDDEN, HIDDEN), "b2": np.zeros(HIDDEN, np.float32),
        "W3": glorot(HIDDEN, N_CLASSES), "b3": np.zeros(N_CLASSES, np.float32),
    }


def apply_np(params, x: np.ndarray) -> np.ndarray:
    """Numpy forward twin (float32) — parity anchor for the jax path."""
    h = np.maximum(x.astype(np.float32) @ params["W1"] + params["b1"], 0.0)
    h = np.maximum(h @ params["W2"] + params["b2"], 0.0)
    return h @ params["W3"] + params["b3"]


_cached: dict[str, dict[str, np.ndarray]] = {}


def load_params(path: str | None = None) -> dict[str, np.ndarray]:
    path = path or DEFAULT_WEIGHTS
    if path not in _cached:
        with np.load(path) as z:
            _cached[path] = {k: z[k].astype(np.float32) for k in _PARAM_KEYS}
    return _cached[path]


def save_params(path: str, params) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: np.asarray(params[k], np.float32)
                      for k in _PARAM_KEYS})


def candidate_sites(counts: np.ndarray, ref_codes: np.ndarray,
                    min_depth: int = 3, min_alt: int = 2):
    """Cheap candidate gate (superset of the counting caller's cuts): the
    network, not a frequency threshold, makes the final call.

    Two-phase like snp_caller.call_snps: a total-non-ref pre-filter picks
    candidate rows, and the per-allele argmax runs only on those — no
    (L, 4)-sized temporaries at chromosome scale."""
    ref_safe = np.minimum(ref_codes, 3).astype(np.int64)
    depth_all = counts.sum(axis=1)
    ref_count = np.take_along_axis(counts, ref_safe[:, None], axis=1)[:, 0]
    cand = np.flatnonzero((depth_all >= min_depth)
                          & (depth_all - ref_count >= min_alt)
                          & (ref_codes < 4))
    sub = counts[cand].copy()
    sub[np.arange(len(cand)), ref_safe[cand]] = -1
    alt_code = sub.argmax(axis=1)
    alt_count = counts[cand, alt_code]
    keep = (alt_count >= min_alt) & (alt_code != ref_safe[cand])
    pos = cand[keep].astype(np.int64)
    return (pos, alt_code[keep].astype(np.uint8), alt_count[keep],
            depth_all[pos])


def _label_candidates(pos, alt_code, truth_pos, truth_alt, truth_gt):
    """0 non-variant / 1 het / 2 hom, matched on position AND alt allele."""
    labels = np.zeros(len(pos), dtype=np.int64)
    if len(truth_pos) == 0:
        return labels
    order = np.argsort(truth_pos)
    tp, ta = truth_pos[order], truth_alt[order]
    tg = truth_gt[order].sum(axis=1)
    j = np.searchsorted(tp, pos)
    ok = (j < len(tp))
    jc = np.minimum(j, len(tp) - 1)
    hit = ok & (tp[jc] == pos) & (ta[jc] == alt_code)
    labels[hit] = np.where(tg[jc[hit]] >= 2, 2, 1)
    return labels


def build_training_set(seeds=(11, 12, 13, 14),
                       coverages=(4.0, 5.0, 6.0, 8.0, 12.0, 20.0, 30.0),
                       error_rates=(0.01, 0.02, 0.035, 0.05),
                       contig_len: int = 300_000):
    """Simulate, pileup, window — (X, y) over seeds × coverage × error-rate
    regimes (each seed draws one coverage and one error rate, round-robin,
    so the corpus spans the operating envelope without a full grid)."""
    import shutil
    import tempfile

    from duet_tpu_torch.models.snp_caller_host import (
        SnpCallConfig, count_alleles, pileup_observations)
    from duet_tpu_torch.sim.simulate import SimConfig, simulate_dataset

    try:  # native decoder: the corpus build is reader-bound otherwise
        from duet_tpu_torch.io.native_ingest import load_read_store_native \
            as load_read_store
    except Exception:
        from duet_tpu_torch.io.readstore import load_read_store

    xs, ys = [], []
    cfg = SnpCallConfig()
    jobs = [(seed, cov, error_rates[(i + j) % len(error_rates)])
            for i, seed in enumerate(seeds)
            for j, cov in enumerate(coverages)]
    for seed, cov, err in jobs:
            tmp = tempfile.mkdtemp(prefix="nn_snp_train_")
            try:
                sim = SimConfig(contigs={"chrT": contig_len}, seed=seed,
                                coverage=cov, sub_error=err)
                truth = simulate_dataset(tmp, sim)
                store = load_read_store(os.path.join(tmp, "reads.bam"))
                from duet_tpu_torch.io.fasta import FastaFile

                ref = FastaFile(os.path.join(tmp, "ref.fa"))
                codes = ref.fetch_codes("chrT")
                cr = store.contigs["chrT"]
                obs = pileup_observations(cr, cfg)
                counts = count_alleles(obs[0], obs[1], obs[2], len(codes),
                                       cfg.min_base_qual)
                pos, alt_code, _, _ = candidate_sites(counts, codes)
                feats = extract_features(counts, codes, pos, alt_code)
                labels = _label_candidates(
                    pos, alt_code, truth.snp_pos["chrT"],
                    truth.snp_alt["chrT"], truth.snp_gt["chrT"])
                xs.append(feats)
                ys.append(labels)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    return np.concatenate(xs), np.concatenate(ys)
