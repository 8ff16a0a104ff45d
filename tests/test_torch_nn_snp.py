"""The neural SNP caller of the torch port against the JAX package: the
shipped weights loaded through duet_tpu's loader give the logits of the
numpy forward up to float32 summation order, and the same classes as the
numpy and JAX forwards.

Tolerance: atol 1e-5 plus rtol 1e-6.  Logits reach |64| on simulator
features, where one float32 ulp is 7.6e-6; a different summation order
moves them by a few ulp (2 measured), which a bare atol of 1e-5 would not
admit at that magnitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duet_tpu.models import nn_snp as jnn
from duet_tpu_torch.models import nn_snp as tnn


def sim_counts(sim_dataset):
    from duet_tpu.io.fasta import FastaFile
    from duet_tpu.io.readstore import load_read_store
    from duet_tpu.models.snp_caller import (SnpCallConfig, count_alleles,
                                            pileup_observations)

    out, _, _ = sim_dataset
    cr = load_read_store(f"{out}/reads.bam").contigs["chr21"]
    codes = FastaFile(f"{out}/ref.fa").fetch_codes("chr21")
    cfg = SnpCallConfig()
    obs = pileup_observations(cr, cfg)
    return count_alleles(obs[0], obs[1], obs[2], len(codes),
                         cfg.min_base_qual), codes


def features(source, sim_dataset):
    """Features of the simulator's candidate sites, or uniform noise in
    the features' [0, 1] range."""
    if source == "random":
        rng = np.random.default_rng(3)
        return rng.random((4096, jnn.N_FEATURES)).astype(np.float32)
    counts, codes = sim_counts(sim_dataset)
    pos, alt, _, _ = jnn.candidate_sites(counts, codes)
    return jnn.extract_features(counts, codes, pos, alt)


def test_params_layout():
    params = jnn.load_params()
    model = tnn.params_from_numpy(params)
    np.testing.assert_array_equal(model.fc1.weight.detach().numpy(),
                                  params["W1"].T)
    np.testing.assert_array_equal(model.fc3.bias.detach().numpy(),
                                  params["b3"])
    assert tuple(model.fc1.weight.shape) == (jnn.HIDDEN, jnn.N_FEATURES)


@pytest.mark.parametrize("source", ["sim", "random"])
def test_forward_matches_numpy_and_jax(source, sim_dataset):
    params = jnn.load_params()
    x = features(source, sim_dataset)
    with torch.no_grad():
        logits = tnn.load_model()(torch.from_numpy(x)).numpy()
    want = jnn.apply_np(params, x)
    np.testing.assert_allclose(logits, want, rtol=1e-6, atol=1e-5)
    cls = logits.argmax(axis=1)
    np.testing.assert_array_equal(cls, want.argmax(axis=1))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    np.testing.assert_array_equal(
        cls, np.asarray(jnn.apply(jparams, jnp.asarray(x)).argmax(axis=1)))


def test_nn_call_snps_matches_jax(sim_dataset):
    counts, codes = sim_counts(sim_dataset)
    want = jnn.nn_call_snps("chr21", counts, codes)
    got = tnn.nn_call_snps("chr21", counts, codes, batch=1000)
    assert len(got.pos) > 0
    for f in ("pos", "ref_code", "alt_code", "is_het", "depth", "alt_count"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
