"""The torch port's (dp, sp) device mesh against duet_tpu's on the CPU:
the sharded phase-and-tag, clustering and pileup are array_equal to
duet_tpu's shard_map versions (run on the 8 virtual CPU devices that
tests/conftest.py forces) and to the port's single-device functions, and
the pipeline under --mesh writes artifacts byte-identical to duet_tpu's
mesh run and to the port's single-device run.  The port's mesh is 8
logical CPU devices; the tolerance is none."""

import gzip
import json
import os

import jax
import numpy as np
import pytest
import torch

from duet_tpu.models import snp_phaser as jsp
from duet_tpu.ops.cluster import cluster_device_to_host as j_cluster_dev
from duet_tpu.ops.cluster import cluster_host as j_cluster_host
from duet_tpu.ops.haplotag import block_onehot_from_ids, densify_window
from duet_tpu.ops.pileup import pileup_counts as j_pileup_counts
from duet_tpu.parallel.mesh import make_mesh as j_make_mesh
from duet_tpu.parallel.mesh import phase_and_tag_sharded as j_sharded
from duet_tpu.parallel.shard_cluster import cluster_sharded as j_cluster_sh
from duet_tpu.pipeline import PipelineConfig as JaxConfig
from duet_tpu.pipeline import run_pipeline as jax_run
from duet_tpu_torch.ops import cluster as tc
from duet_tpu_torch.ops.haplotag import phase_and_tag
from duet_tpu_torch.ops.pileup import pileup_counts
from duet_tpu_torch.parallel import (
    cluster_sharded,
    make_mesh,
    pad_to_multiple,
    phase_and_tag_sharded,
)
from duet_tpu_torch.pipeline import (
    PipelineConfig,
    run_pipeline,
    run_pipeline_streaming,
)
from test_cluster_kernel import random_signatures
from test_haplotag_kernel import synthetic_allele_matrix
from test_pileup_kernel import random_observations

CPU = torch.device("cpu")
GEOMETRIES = [(4, 2), (8, 1), (2, 4), (1, 8)]
ARTIFACTS = ("snp_calling/pileup.vcf.gz", "sv_calling/variants.vcf",
             "phased_sv.vcf")


def _meshes(dp, sp):
    """(duet_tpu's mesh over the virtual devices, the port's CPU mesh)."""
    return (j_make_mesh(dp=dp, sp=sp, devices=jax.devices()[: dp * sp]),
            make_mesh(dp, sp, [CPU] * (dp * sp)))


def _read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("sweeps", [0, 2])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_phase_and_tag_sharded_matches_duet_and_single(geometry, sweeps):
    dp, sp = geometry
    rng = np.random.default_rng(42 + sweeps)
    am = synthetic_allele_matrix(rng, n_reads=96, n_sites=64, density=0.3)
    phase, block_id, block_ps = jsp._initial_phase(am)
    A, W = (np.asarray(x) for x in densify_window(
        am, 0, am.n_sites, np.arange(am.n_reads)))
    onehot = np.asarray(block_onehot_from_ids(block_id, max(len(block_ps), 1)))
    A = pad_to_multiple(pad_to_multiple(A, dp, 0), sp, 1)
    W = pad_to_multiple(pad_to_multiple(W, dp, 0), sp, 1)
    ph = pad_to_multiple(phase.astype(np.float32), sp, 0)
    oh = pad_to_multiple(onehot, sp, 0)
    j_mesh, t_mesh = _meshes(dp, sp)
    want = j_sharded(j_mesh, A, W, ph, oh, sweeps=sweeps)
    got = phase_and_tag_sharded(t_mesh, A, W, ph, oh, sweeps=sweeps)
    single = phase_and_tag(*(torch.from_numpy(x) for x in (A, W, ph, oh)),
                           sweeps)
    for g, w, name in zip(got, want, ("hap", "pc", "best_block", "phase")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        assert torch.equal(g, single[name]), name
    assert (got[0] != 0).sum() > 0


def _cluster_cases():
    """The four cases of tests/test_shard_cluster.py (the random one per
    linkage): (pos, length, reads, linkage, max_dist, n_clusters or None)."""
    rng = np.random.default_rng(42)
    for linkage, max_dist in ((tc.GAP, 200), (tc.SPAN, 0)):
        sets = []
        for _ in range(4):
            k = int(rng.integers(5, 700))
            sets.append((np.sort(rng.integers(0, 4000, size=k)),
                         rng.integers(40, 500, size=k),
                         rng.integers(0, 60, size=k)))
        yield f"random-{linkage}", sets, linkage, max_dist, None
    k = 64
    yield "spanning", [(np.arange(k) * 10, np.full(k, 100),
                        np.arange(k) % 7)], tc.GAP, 200, 1
    yield "edge", [(np.concatenate([np.arange(16) * 5,
                                    1_000_000 + np.arange(48) * 5]),
                    np.full(64, 80), np.arange(64))], tc.GAP, 200, 2
    e = np.zeros(0, dtype=np.int64)
    yield "empty-single", [(e, e, e), (np.array([5]), np.array([100]),
                                       np.array([3]))], tc.GAP, 200, None


@pytest.mark.parametrize("case", list(_cluster_cases()),
                         ids=lambda c: c[0])
def test_cluster_sharded_matches_duet_and_host(case):
    """Seams: halo exchange, a chain across every shard edge, a break
    exactly at an edge, the empty and one-signature inputs (2 x 4 mesh)."""
    _, sets, linkage, max_dist, n_clusters = case
    j_mesh, t_mesh = _meshes(2, 4)
    for pos, length, reads in sets:
        pos, length, reads = (np.asarray(x, np.int64)
                              for x in (pos, length, reads))
        args = (pos, length, reads, linkage, max_dist, 9, 10)
        got = cluster_sharded(t_mesh, *args)
        want = j_cluster_sh(j_mesh, *args)
        host = tc.cluster_host(*args)
        for g, w, h, j in zip(got, want, host, j_cluster_host(*args)):
            np.testing.assert_array_equal(g, np.asarray(w))
            np.testing.assert_array_equal(g, h)
            np.testing.assert_array_equal(h, j)
        if n_clusters is not None:
            assert len(got[0]) == n_clusters


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("linkage,max_dist", [(tc.GAP, 200), (tc.SPAN, 0)])
def test_cluster_device_matches_duet(seed, linkage, max_dist):
    rng = np.random.default_rng(seed)
    pos, length, reads = random_signatures(rng, k=int(rng.integers(5, 200)))
    args = (pos, length, reads, linkage, max_dist, 9, 10)
    got = tc.cluster_device_to_host(*args, torch_device=CPU)
    for g, w, h in zip(got, j_cluster_dev(*args), tc.cluster_host(*args)):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, h)


@pytest.mark.parametrize("seed", range(3))
def test_pileup_counts_matches_duet(seed):
    rng = np.random.default_rng(seed)
    L = 500
    positions, bases, quals = random_observations(rng, L, 5000)
    positions[:7] = [-3, L, L + 2, 0, L - 1, -1, 2 * L]   # off the contig
    want = np.asarray(j_pileup_counts(positions, bases, quals, L, 10))
    got = pileup_counts(*(torch.from_numpy(x)
                          for x in (positions, bases, quals)), L, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and got.sum() > 0


@pytest.fixture(scope="module")
def two_contigs(tmp_path_factory):
    """Two 120 kb contigs (duet_tpu's streaming mesh dataset)."""
    from duet_tpu.sim import SimConfig, simulate_dataset

    d = tmp_path_factory.mktemp("mesh_data")
    simulate_dataset(str(d), SimConfig(contigs={"chrA": 120_000,
                                                "chrB": 120_000},
                                       seed=23, coverage=14.0))
    return str(d)


def _paths(data):
    return dict(bam=os.path.join(data, "reads.bam"),
                reference=os.path.join(data, "ref.fa"),
                include_all_ctgs=True)


@pytest.fixture(scope="module")
def single_device(two_contigs, tmp_path_factory):
    """The port's plain single-device run of the dataset."""
    out = str(tmp_path_factory.mktemp("single") / "out")
    run_pipeline(PipelineConfig(output=out, device="cpu",
                                **_paths(two_contigs)))
    return out


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_sharded_pileup_matches_duet_and_host(two_contigs, geometry):
    from duet_tpu.io.fasta import FastaFile
    from duet_tpu.io.readstore import load_read_store as j_load
    from duet_tpu.models.snp_caller import SnpCallConfig as JSnpCfg
    from duet_tpu.parallel.shard_pileup import call_snps_sharded as j_call
    from duet_tpu_torch.io.readstore import load_read_store
    from duet_tpu_torch.models.snp_caller import call_contig_snps
    from duet_tpu_torch.models.snp_caller_host import SnpCallConfig
    from duet_tpu_torch.parallel.shard_pileup import call_snps_sharded

    bam = os.path.join(two_contigs, "reads.bam")
    ref = FastaFile(os.path.join(two_contigs, "ref.fa"))
    j_store, t_store = j_load(bam), load_read_store(bam)
    j_mesh, t_mesh = _meshes(*geometry)
    for contig, cr in t_store.contigs.items():
        codes = ref.fetch_codes(contig)
        got = call_snps_sharded(t_mesh, contig, cr, codes, SnpCallConfig())
        want = j_call(j_mesh, contig, j_store.contigs[contig], codes,
                      JSnpCfg())
        host, _ = call_contig_snps(contig, cr, codes, SnpCallConfig())
        for f in ("pos", "alt_code", "is_het", "depth", "alt_count"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
            np.testing.assert_array_equal(getattr(got, f), getattr(host, f),
                                          err_msg=f)
        assert len(got.pos) > 0


@pytest.mark.parametrize("mesh", ["4,2", "8,1", "2,4"])
def test_mesh_pipeline_matches_duet_and_single(two_contigs, single_device,
                                               tmp_path, mesh):
    paths = _paths(two_contigs)
    want = str(tmp_path / "jax")
    got = str(tmp_path / "torch")
    jax_run(JaxConfig(output=want, mesh=mesh, **paths))
    run_pipeline(PipelineConfig(output=got, mesh=mesh, device="cpu",
                                **paths))
    names = list(ARTIFACTS) + [
        f"snp_phasing/{n}"
        for n in sorted(os.listdir(os.path.join(want, "snp_phasing")))]
    assert sorted(os.listdir(os.path.join(got, "snp_phasing"))) == \
        sorted(os.listdir(os.path.join(want, "snp_phasing")))
    for name in names:
        assert _read(os.path.join(got, name)) == \
            _read(os.path.join(want, name)), name
    for name in ARTIFACTS:
        assert _read(os.path.join(got, name)) == \
            _read(os.path.join(single_device, name)), name
    with open(os.path.join(got, "metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(want, "metrics.json")) as f:
        ref_metrics = json.load(f)
    dp, sp = (int(x) for x in mesh.split(","))
    assert metrics["mesh"] == ref_metrics["mesh"] == {"dp": dp, "sp": sp}
    # the port alone records its BGZF inflate: on the host on the CPU
    assert metrics["backends"].pop("ingest_inflate") == "host"
    assert metrics["device_dispatch"].pop("ingest_inflate") == {"host": 1}
    assert metrics["backends"] == ref_metrics["backends"]
    for stage in ("snp_pileup", "sv_cluster", "haplotag"):
        assert metrics["backends"][stage] == "mesh", stage
    assert metrics["device_dispatch"] == ref_metrics["device_dispatch"]


def test_mesh_auto_resolves(two_contigs, single_device, tmp_path):
    """'auto' over the 8 logical CPU devices is 4 x 2, as duet_tpu's over
    its 8 virtual devices."""
    out = str(tmp_path / "auto")
    run_pipeline(PipelineConfig(output=out, mesh="auto", device="cpu",
                                **_paths(two_contigs)))
    for name in ARTIFACTS:
        assert _read(os.path.join(out, name)) == \
            _read(os.path.join(single_device, name)), name
    with open(os.path.join(out, "metrics.json")) as f:
        assert json.load(f)["mesh"] == {"dp": 4, "sp": 2}


def test_mesh_rejects_oversubscription(two_contigs, tmp_path):
    with pytest.raises(ValueError, match="needs 32 devices, have 8"):
        run_pipeline(PipelineConfig(output=str(tmp_path / "over"),
                                    mesh="16,2", device="cpu",
                                    **_paths(two_contigs)))


def test_streaming_mesh_matches_batch(two_contigs, single_device, tmp_path):
    """--stream composes with the mesh: every artifact byte-identical to
    the single-device batch run, as duet_tpu's streaming mesh run is."""
    out = str(tmp_path / "stream_mesh")
    run_pipeline_streaming(PipelineConfig(output=out, mesh="4,2",
                                          device="cpu",
                                          **_paths(two_contigs)))
    for name in ARTIFACTS:
        assert _read(os.path.join(out, name)) == \
            _read(os.path.join(single_device, name)), name
    with open(os.path.join(out, "metrics.json")) as f:
        backends = json.load(f)["backends"]
    assert backends["haplotag"] == backends["sv_cluster"] == "mesh"
    assert backends["snp_pileup"] == "mesh"
