"""Tests of the torch port that need a CUDA card; they skip on a host
without one.  This file imports no jax, so it also runs on a GPU machine
that has none:

    DUET_TPU_TEST_REAL=1 python -m pytest tests/test_torch_cuda.py -q

(DUET_TPU_TEST_REAL keeps tests/conftest.py from pinning jax to the CPU.)
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from duet_tpu_torch.ops import haplotag_kernel
from duet_tpu_torch.ops.haplotag import phase_and_tag_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", ["pipeline_shape", "edge_1", "edge_2"])
def test_kernel_matches_plain(cuda_device, case):
    """The hand kernel against the plain version on the card, at the
    pipeline's launch shape and on chip_smoke.py's edge cases."""
    if case == "pipeline_shape":
        A, W, rhs = chip_smoke.pipeline_shaped_inputs(seed=3)
        T, B = 16, 126
    else:
        A, W, rhs, T, B = chip_smoke.edge_case_inputs(int(case[-1]))
    a = torch.from_numpy(A).to(cuda_device)
    w = torch.from_numpy(W).to(torch.bfloat16).to(cuda_device)
    r = torch.from_numpy(rhs).to(torch.bfloat16).to(cuda_device)
    before = haplotag_kernel.LAUNCHES
    got = haplotag_kernel.haplotag_score_batch(a, w, r, T, B)
    want = phase_and_tag_batch(a, w, r, T, B)
    torch.cuda.synchronize()
    assert haplotag_kernel.LAUNCHES == before + 1
    for name, x, y in zip(("hap", "pc", "best"), got, want):
        assert x.device == cuda_device and x.dtype == torch.int32
        assert torch.equal(x, y), name


def test_device_routes_on_card_match_host(cuda_device, tmp_path):
    """Every device route on the card (pileup, clustering, refine, dense
    scoring, decision) writes the artifacts of the host-only run."""
    from duet_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from duet_tpu_torch.sim import SimConfig, simulate_dataset

    data = str(tmp_path / "data")
    simulate_dataset(data, SimConfig(contigs={"chr1": 150_000,
                                              "chr2": 100_000},
                                     seed=9, coverage=15.0))
    outs = {}
    for mode in ("on", "off"):
        outs[mode] = str(tmp_path / mode)
        run_pipeline(PipelineConfig(bam=os.path.join(data, "reads.bam"),
                                    reference=os.path.join(data, "ref.fa"),
                                    output=outs[mode], device_stages=mode,
                                    device="cuda"))
    with open(os.path.join(outs["on"], "metrics.json")) as f:
        backends = json.load(f)["backends"]
    assert set(backends.values()) == {"device"}, backends
    for name in ("snp_calling/pileup.vcf.gz", "sv_calling/variants.vcf",
                 "phased_sv.vcf"):
        assert chip_smoke._read(os.path.join(outs["on"], name)) == \
            chip_smoke._read(os.path.join(outs["off"], name)), name


def test_nn_forward_on_card_matches_cpu(cuda_device):
    from duet_tpu_torch.models.nn_snp import N_FEATURES, load_model

    x = torch.from_numpy(
        np.random.default_rng(1).random((4096, N_FEATURES), np.float32))
    with torch.no_grad():
        gpu = load_model(device=cuda_device)(x.to(cuda_device)).cpu()
        cpu = load_model()(x)
    assert torch.equal(gpu.argmax(1), cpu.argmax(1))
