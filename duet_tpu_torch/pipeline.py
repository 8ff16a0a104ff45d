"""The pipeline, BAM -> phased_sv.vcf, with its device routes on torch.

Port of ``duet_tpu.pipeline``: the batch run (``run_pipeline``, with
``--resume``), the contig-major streaming run (``run_pipeline_streaming``,
``--stream``) and the final stage alone from on-disk artifacts
(``run_phase_only``, ``--phase-only``).  They run the same four stages (SNP
calling -> SV calling -> SNP phasing -> SV phasing) and write the same
on-disk artifacts and ``metrics.json`` schemas.  The host helpers (ingest,
the artifact writers, contig naming, the run state, the multi-process part
files) are copies of the JAX package's, and the stages are copies whose
device lines call the port.

The device is explicit: ``PipelineConfig.device`` ('cuda' by default, or
'cpu', which runs the same torch routes on the host).  ``device_stages``
keeps its meaning — 'on' forces every device route onto that device at any
size, 'off' keeps every stage on the host, and 'auto' uses the device only
when it is a GPU and the stage's input clears the size gate at which the
device route overtook the host route on the H100
(``python -m duet_tpu_torch.route_crossover``; PipelineConfig's *_H100_*
constants).  Outputs are byte-identical whichever route runs.

``--mesh DP,SP`` shards SNP calling, SV clustering and read scoring over a
dp x sp grid of this process's devices (``parallel.mesh``; on the CPU, 8
logical devices).  As in duet_tpu the mesh is an explicit opt-in: those
stages run on it whatever ``device_stages`` says, and phasing whenever the
device kernels are allowed (not under --host-kernel).

A multi-process run (``--num-processes`` / ``--process-id``, joined by
torch.distributed on gloo at ``--coordinator``, or emulated without it)
gives each process the contigs it owns round-robin; the stage outputs
travel as part files in OUTPUT/parts/, and process 0 merges them and
writes the final artifacts.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from duet_tpu_torch.device import resolve
from duet_tpu_torch.io.fasta import FastaFile
from duet_tpu_torch.io.readstore import ReadStore, load_read_store
from duet_tpu_torch.io.vcf import (
    append_phased_sv_records,
    parse_sv_vcf,
    write_phased_sv_header,
)
from duet_tpu_torch.models.snp_caller import (
    call_snps_for_contig,
    call_snps_for_store,
    write_pileup_vcf,
)
from duet_tpu_torch.models.snp_caller_host import (
    ContigSnps,
    SnpCallConfig,
    read_pileup_vcf,
)
from duet_tpu_torch.models.snp_phaser import (
    phase_contig,
    phase_contig_core,
    score_contigs_batched,
    write_phased_snp_vcf,
)
from duet_tpu_torch.models.snp_phaser_host import (
    PhaseResult,
    read_hap_map,
)
from duet_tpu_torch.models.sv_caller import call_contig_with_evidence
from duet_tpu_torch.models.sv_caller_host import (
    SvCallConfig,
    call_bnds,
    write_sv_vcf,
)
from duet_tpu_torch.models.sv_phaser import phase_callset
from duet_tpu_torch.utils import devcost, dispatch, spans
from duet_tpu_torch.utils.chrom import resolve_contig_names, strip_chr
from duet_tpu_torch.utils.logging import (
    StageTimer,
    get_logger,
    setup_logging,
    stage_key,
)
from duet_tpu_torch.utils.spans import span

_CPU = torch.device("cpu")


@dataclass
class PipelineConfig:
    """duet_tpu's flag set, with its fields and defaults (reference-CLI
    parity, src/duet/utils.py:19-44), plus the explicit torch device."""

    bam: str
    reference: str
    output: str
    threads: int = 4                    # -t (ingest/host parallelism hint)
    min_allele_frequency: float = 0.25  # -m
    cluster_max_distance: float = 0.9   # -c
    sv_min_size: int = 50               # -s
    min_support_read: int = 2           # -r
    include_all_ctgs: bool = False      # -a
    sv_caller: str = "cutesv"           # -b: cutesv|sniffles -> gap linkage, svim -> span
    resume: bool = False                # skip stages whose artifacts exist
    use_device_kernel: bool = True      # run the decision stage on device
    haplotag_bam: bool = False          # also write per-contig HP/PC/PS BAMs
    phase_bnd: bool = False             # genotype+phase breakends too (the
                                        # reference drops them at the SVLEN
                                        # filter, sv_phasing_fn.py:189)
    decision_model: str = "verbatim"    # "verbatim" (the reference's T1-T5
                                        # tree, the parity contract) |
                                        # "learned" (CART refit on framework
                                        # features, models/decision_model)
    min_junction_evidence: float = 0.0  # split phase-set blocks at weak
                                        # junctions below an ABSOLUTE
                                        # evidence threshold (min(this,
                                        # block median/20)); superseded by
                                        # the adaptive rule below but kept
                                        # for explicit-threshold runs
    adaptive_junction_split: bool = True
                                        # coverage-adaptive weak-junction
                                        # splitting: split where converged
                                        # junction evidence is a >=20x
                                        # outlier vs the block median AND
                                        # spanning reads disagree (E/M <
                                        # 0.8) or number <=1.  No absolute
                                        # scale, so it does not backfire at
                                        # low coverage the way an absolute
                                        # threshold does (docs/PC_SCALE.md)
    # multi-process (multi-host) run: contigs are round-robin owned per
    # process, stage outputs exchanged as part-files on the shared
    # filesystem, process 0 is the single writer of the final artifacts
    # (SURVEY.md §5.8). coordinator wires torch.distributed (gloo); without
    # it the same ownership logic runs "emulated" (tested single-machine).
    num_processes: int | None = None
    process_id: int | None = None
    coordinator: str | None = None

    snp_model: str = "auto"             # "auto" (measured-envelope pick,
                                        # models/snp_caller.choose_snp_model)
                                        # | "counts" | "nn" (neural pileup
                                        # caller — Clair3's role, on the MXU)
    device_stages: str = "auto"         # route pileup counting + SV
                                        # clustering through the jitted
                                        # device kernels: "auto" (when an
                                        # accelerator backend is live),
                                        # "on" (force, e.g. CPU parity
                                        # tests), "off"
    mesh: str | None = None             # "DP,SP" or "auto": shard the
                                        # haplotag-scoring and clustering
                                        # stages over a (data-parallel,
                                        # sequence-parallel) device mesh
                                        # with explicit collectives
                                        # (parallel.mesh); outputs stay
                                        # byte-identical to single-device
    device: str = "cuda"                # "cuda" | "cpu": where device routes run

    # auto's size gates, from `python -m duet_tpu_torch.route_crossover` run
    # twice in one call on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md
    # §5).  A run's gate is the smallest size from which the device route's
    # slowest of 5 timed calls beat the host route's fastest at every
    # larger size measured; each constant is the larger of the two runs'
    # gates.  None: the device never did, so auto keeps the stage on the
    # host.  Unannotated: class attributes, not dataclass fields.
    # SV clustering, a contig's signatures (a simulated contig's, tiled):
    # the device 0.0050-0.0051 s against the host's 0.0066-0.0086 s at
    # 64,000; at 32,000 faster at the median (0.0027-0.0034 against
    # 0.0031-0.0046 s), inside the spread.
    SV_GATE_H100_K = 64_000
    # refine + read scoring, allele-matrix entries: the sparse scorer
    # 0.0031-0.0039 s against the host's 0.0065-0.0077 s at 49,995,
    # 0.0167-0.0214 against 0.1070-0.1383 s at 799,992; at 24,993 outside
    # the spread in one run of two; the host ahead at 9,999 (0.0011-0.0015
    # against 0.0018-0.0023 s).
    PHASING_GATE_H100_NNZ = 49_995
    # the SV decision pass, calls (a simulated callset, tiled): the device
    # faster at the median from 1,000-2,000 calls (1.31-1.41 against
    # 1.61-1.64 s at 64,000), but its slowest call never beat the host's
    # fastest: the host's calls spread by 36-151% at every size from 2,000.
    DECIDE_GATE_H100_CALLS = None
    # the device pileup (the counting rule: --snp-model counts), read
    # bases: on a whole store as a batch run counts it, the device
    # 0.1024-0.1257 s against the host's 0.1312-0.1625 s at 85,291,615 and
    # 0.0523-0.0669 against 0.0590-0.0898 s at 41,494,548; at 20,763,483
    # outside the spread in one run of two.  On one contig as --stream
    # counts it: 0.0337-0.0383 against 0.0541-0.0747 s at 20,735,789; at
    # 10,286,969 outside the spread in one run of two.
    PILEUP_GATE_H100_BASES = 41_494_548
    PILEUP_CONTIG_GATE_H100_BASES = 20_735_789

    def torch_device(self) -> torch.device:
        return resolve(self.device)

    def stages_on_device(self) -> bool:
        """Whether the device routes run (each behind its size gate): never
        under 'off' or --host-kernel, always under 'on', and under 'auto'
        when the device is a GPU (the port's ``_accelerator_live``)."""
        if not self.use_device_kernel or self.device_stages == "off":
            return False
        return self.device_stages == "on" or \
            self.torch_device().type == "cuda"

    def pileup_gate(self, stream: bool = False) -> int | None:
        """auto's pileup gate in read bases: a batch run's store, or under
        --stream one contig.  None under any --snp-model but counts: the
        device pileup implements the counting rule, while the host route of
        --snp-model auto picks the rule from the host's count
        (``choose_snp_model``), so only the counting rule gives the same
        calls on both routes."""
        if self.snp_model != "counts":
            return None
        return self.PILEUP_CONTIG_GATE_H100_BASES if stream \
            else self.PILEUP_GATE_H100_BASES

    def pileup_on_device(self, n_bases: int | None = None,
                         stream: bool = False) -> bool:
        """Whether the pileup of `n_bases` read bases runs on the device
        (None: whether any size would): always under 'on'; under 'auto'
        on a GPU from the gate on, where the device pileup with its hand
        kernels beat the native host count on the H100 by more than the
        spread between calls (route_crossover's pileup rows, PERF.md §5)."""
        if not self.stages_on_device():
            return False
        if self.device_stages == "on":
            return True
        gate = self.pileup_gate(stream)
        return gate is not None and (n_bases is None or n_bases >= gate)

    def phasing_device_min_nnz(self) -> int:
        """The phasing stage's allele-matrix gate: 0 under 'on'."""
        return 0 if self.device_stages == "on" \
            else self.PHASING_GATE_H100_NNZ

    def snp_cfg(self, n_bases: int | None = None,
                stream: bool = False) -> SnpCallConfig:
        """The SNP stage's config for a pileup of `n_bases` read bases
        (``pileup_on_device``)."""
        return SnpCallConfig(min_af=self.min_allele_frequency,
                             model=self.snp_model,
                             device=self.pileup_on_device(n_bases, stream))

    def sv_cluster_min_k(self) -> int:
        return 0 if self.device_stages == "on" else self.SV_GATE_H100_K

    def sv_cfg(self) -> SvCallConfig:
        return SvCallConfig(
            linkage="span" if self.sv_caller == "svim" else "gap",
            cluster_max_distance=self.cluster_max_distance,
            min_size=self.sv_min_size,
            min_support=self.min_support_read,
            device=self.stages_on_device(),
            # "on" forces the kernel regardless of input size (parity tests,
            # real accelerator hosts); auto keeps the H100's size gate
            device_min_k=self.sv_cluster_min_k(),
        )

    def decide_on_device(self, n_calls: int) -> bool:
        gate = self.DECIDE_GATE_H100_CALLS
        return self.stages_on_device() and (
            self.device_stages == "on"
            or gate is not None and n_calls >= gate)

    def haplotag_mode(self) -> str:
        """The device read scorer: under 'on', which forces every device
        route, the dense route and its hand kernel (haplotag_score); else
        HAPLOTAG_DEVICE_MODE, the scorer that was faster on the card."""
        from duet_tpu_torch.models.snp_phaser import HAPLOTAG_DEVICE_MODE

        return "dense" if self.device_stages == "on" \
            else HAPLOTAG_DEVICE_MODE

    def device_size_gates(self) -> dict:
        """metrics.json's record of auto's gates and its read scorer (the
        pileup's two are None but under --snp-model counts, where they
        route)."""
        from duet_tpu_torch.models.snp_phaser import HAPLOTAG_DEVICE_MODE

        return {
            "pileup_min_bases": self.pileup_gate(),
            "pileup_contig_min_bases": self.pileup_gate(stream=True),
            "sv_cluster_min_signatures": self.SV_GATE_H100_K,
            "phasing_min_nnz": self.PHASING_GATE_H100_NNZ,
            "decide_min_calls": self.DECIDE_GATE_H100_CALLS,
            "haplotag_mode": HAPLOTAG_DEVICE_MODE,
        }

    def inflate_device(self) -> torch.device | None:
        """Where native ingest inflates the BAM's BGZF members: the card
        (``ops.bgzf_inflate``) whenever the stages run on a CUDA device
        ('auto' or 'on'); else None, the host's zlib pool."""
        dev = self.torch_device()
        if self.stages_on_device() and dev.type == "cuda":
            return dev
        return None

    def nn_device(self) -> torch.device:
        """Where the neural SNP caller runs: the device when the stages
        run there, else the host."""
        return self.torch_device() if self.stages_on_device() else _CPU


def _start_card(cfg: PipelineConfig) -> Future | None:
    """Where a device route may run on a card, start the card's context
    and load the phasing kernels (``ops.sparse_power.warm_up``) on a
    thread while the host decodes the BAM: in a fresh process the first
    device stage would pay for both otherwise (under auto, phasing).  No
    stage waits for it; the run joins it at its end, raising its error.
    Not without a card: the device route then raises, as before."""
    from duet_tpu_torch.ops.sparse_power import warm_up

    dev = cfg.torch_device()
    if dev.type != "cuda" or not torch.cuda.is_available() or \
            not cfg.stages_on_device():
        return None
    ex = ThreadPoolExecutor(1, thread_name_prefix="card-start")
    card = ex.submit(warm_up, dev)
    ex.shutdown(wait=False)
    return card


def _peak_rss_mb() -> float:
    """Peak resident set of this process in MB (ru_maxrss is KB on Linux)."""
    try:
        import resource

        return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1)
    except Exception:
        return 0.0


def check_envs(cfg: PipelineConfig) -> None:
    """Pre-flight index checks (reference utils.py:46-50 exits unless
    BAM.bai and REF.fai exist)."""
    missing = [p for p in (cfg.bam, cfg.reference, cfg.bam + ".bai",
                           cfg.reference + ".fai") if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            "missing required input(s): " + ", ".join(missing)
            + " (BAM and reference must be indexed)"
        )


@dataclass
class PipelineState:
    """In-memory data plane shared across stages (alongside disk artifacts)."""

    store: ReadStore | None = None
    ref: FastaFile | None = None
    snps: dict[str, ContigSnps] = field(default_factory=dict)
    site_obs: dict[str, tuple] = field(default_factory=dict)
    sv_calls: dict[str, list] = field(default_factory=dict)
    phase_results: dict[str, PhaseResult] = field(default_factory=dict)
    read_haps: dict[str, dict[str, tuple[int, int, int]]] = field(default_factory=dict)
    mesh: object | None = None  # resolved parallel.mesh.Mesh (cfg.mesh)


def _resolve_mesh(cfg: PipelineConfig):
    """Build the (dp, sp) device mesh from cfg.mesh ('DP,SP' or 'auto')
    over this process's devices of cfg.device's type."""
    if cfg.mesh is None:
        return None
    from duet_tpu_torch.parallel.mesh import local_devices, make_mesh

    devices = local_devices(cfg.torch_device())
    n = len(devices)
    if cfg.mesh == "auto":
        sp = 2 if n % 2 == 0 and n >= 4 else 1
        dp = n // sp
    else:
        dp, sp = (int(x) for x in cfg.mesh.split(","))
        if dp * sp > n:
            raise ValueError(
                f"--mesh {cfg.mesh} needs {dp * sp} devices, have {n}")
    get_logger().info("device mesh: dp=%d sp=%d (%d devices)", dp, sp, dp * sp)
    return make_mesh(dp=dp, sp=sp, devices=devices)


def _proc(cfg: PipelineConfig) -> tuple[int, int]:
    """Resolved (process_id, num_processes). Explicit config wins (emulated
    multi-process testing); else the live process group's values.  Without
    cfg.coordinator the process topology is trivially (0, 1)."""
    if cfg.num_processes is not None:
        if cfg.num_processes > 1 and cfg.process_id is None:
            raise ValueError("--num-processes > 1 requires --process-id")
        pid = cfg.process_id or 0
        if not 0 <= pid < cfg.num_processes:
            raise ValueError(
                f"process_id {pid} out of range for {cfg.num_processes} processes")
        return pid, cfg.num_processes
    if cfg.coordinator is None:
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


def _owned_contigs(names: list[str], pid: int, nproc: int) -> list[str]:
    """Round-robin contig ownership over the sorted contig list — every
    process derives the same assignment independently."""
    ordered = sorted(names)
    return [c for i, c in enumerate(ordered) if i % nproc == pid]


def _barrier(cfg: PipelineConfig, name: str) -> None:
    """Cross-process rendezvous; a no-op when emulated (the test harness
    sequences the processes) or single-process."""
    if cfg.coordinator is None:
        return
    import torch.distributed as dist

    get_logger().info("barrier: %s", name)
    dist.barrier()


def _parts_dir(cfg: PipelineConfig) -> str:
    d = os.path.join(cfg.output, "parts")
    os.makedirs(d, exist_ok=True)
    return d


def _dump_part(cfg: PipelineConfig, stage: str, pid: int, payload) -> None:
    import pickle

    path = os.path.join(_parts_dir(cfg), f"{stage}.part{pid}.pkl")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)  # atomic: readers never see a torn part


def _load_parts(cfg: PipelineConfig, stage: str, nproc: int) -> list:
    """The part files of `stage`: pickles this pipeline's processes wrote
    into OUTPUT/parts/, read only by process 0 of the same run."""
    import pickle

    out = []
    for pid in range(nproc):
        path = os.path.join(_parts_dir(cfg), f"{stage}.part{pid}.pkl")
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    return out


def _work_contigs(cfg: PipelineConfig, available: list[str]) -> list[str]:
    """Contigs to process, honoring -a and accepting chrN/N spellings."""
    canonical = resolve_contig_names(available, cfg.include_all_ctgs)
    out = []
    for name in canonical:
        for c in available:
            if c == name or c == "chr" + name or strip_chr(c) == name:
                out.append(c)
                break
    return out


def _sv_protect_intervals(cfg: PipelineConfig, st: PipelineState, cr):
    """Support-read span table of the contig's candidate SV calls (the ones
    that will reach the decision stage): weak-junction splitting must not
    cut a phase set inside these spans, or the call lands in the
    conservative two-PS regime and loses calling/genotyping recall
    (VERDICT r3 weak #5; reference semantics sv_phasing_fn.py:86-105)."""
    from duet_tpu_torch.models.snp_phaser_host import support_read_intervals

    calls = st.sv_calls.get(cr.contig)
    if not calls:
        return None
    names: set[str] = set()
    for c in calls:
        length = abs(getattr(c, "length", None) or getattr(c, "svlen", 0))
        if length >= cfg.sv_min_size and c.support >= cfg.min_support_read \
                and c.gt != "./.":
            names.update(c.read_names)
    if not names:
        return None
    return support_read_intervals(cr, names)


@span("write.haplotag_table")
def _write_haplotag_table(path: str, haps: dict[str, tuple[int, int, int]]) -> None:
    """name<TAB>hap<TAB>ps<TAB>pc — the framework's equivalent of the
    haplotagged-BAM HP/PC/PS artifact (reference snp_phasing.py:27-29)."""
    with open(path, "w") as f:
        for name, (hap, ps, pc) in haps.items():
            f.write(f"{name}\t{hap}\t{ps}\t{pc}\n")


def _writer_threads(cfg: PipelineConfig) -> int:
    """The threads a BGZF artifact deflates on: -t, at most the cores."""
    return min(cfg.threads, os.cpu_count() or cfg.threads)


@span("write.haplotag_bam")
def _write_haplotag_bam(path: str, cr, haps: dict[str, tuple[int, int, int]],
                        contig_lengths: dict[str, int],
                        threads: int = 1) -> dict:
    """Per-contig haplotagged BAM with HP/PC/PS tags — byte-level artifact
    parity with the reference's WhatsHap haplotag output contract
    (snp_phasing.py:27-29), for IGV/downstream consumers — and its .bai.

    The records are encoded column-wise (``io.bam.encode_records``), their
    BGZF blocks deflated on ``threads`` threads, and the index built from
    the writer's own block offsets: the bytes of the per-read writer and
    ``build_bai``'s re-read.  Returns the seconds of each step and the
    bytes written."""
    from duet_tpu_torch.io.bai import bai_from_offsets
    from duet_tpu_torch.io.bam import BamHeader, encode_header, encode_records
    from duet_tpu_torch.io.bgzf import BgzfWriter

    length = contig_lengths.get(cr.contig, 0)
    head = encode_header(BamHeader(
        f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{cr.contig}\tLN:{length}\n",
        [cr.contig], [length],
    ))
    # encode: the records' columns and each chunk; compress: deflating
    # and writing the blocks (the last of them and EOF at the close)
    split = {"encode_s": 0.0, "compress_s": 0.0}
    t = time.perf_counter()
    pos, end, sizes, chunks = encode_records(cr, haps)
    with BgzfWriter(path, threads=threads) as w:
        w.write(head)
        for chunk in chunks:
            t_chunk = time.perf_counter()
            split["encode_s"] += t_chunk - t
            w.write(chunk)
            t = time.perf_counter()
            split["compress_s"] += t - t_chunk
        t_close = time.perf_counter()
        split["encode_s"] += t_close - t
    split["compress_s"] += time.perf_counter() - t_close
    t = time.perf_counter()
    starts = len(head) + np.cumsum(sizes) - sizes
    with open(path + ".bai", "wb") as f:
        f.write(bai_from_offsets(1, np.zeros(cr.n, np.int64), pos, end,
                                 w.voffsets(starts)))
    split["index_s"] = time.perf_counter() - t
    split["bytes"] = os.path.getsize(path)
    return split


def read_haplotag_table(path: str) -> dict[str, tuple[int, int, int]]:
    out = {}
    with open(path) as f:
        for line in f:
            name, hap, ps, pc = line.rstrip("\n").split("\t")
            out[name] = (int(hap), int(ps), int(pc))
    return out


def _ingest(cfg: PipelineConfig,
            only_contigs: set[str] | None = None) -> tuple[ReadStore, str]:
    """Native C++ BAM decode (streaming, threaded BGZF inflate, on the
    card where ``cfg.inflate_device`` says so, + parallel record parse)
    with Python fallback.  Returns (store, backend_name).

    only_contigs: multi-process ownership filter — applied DURING decode by
    the native reader (non-owned contigs' records are skipped at scan time,
    never column-decoded).  A decode that inflates on the card raises
    whatever fails: the card route has no host fallback."""
    card = cfg.inflate_device()
    try:
        from duet_tpu_torch.io.native_ingest import load_read_store_native

        # inflate threads beyond the physical cores only add contention
        n_threads = min(cfg.threads, os.cpu_count() or cfg.threads)
        store = load_read_store_native(
            cfg.bam, n_threads=n_threads, only_contigs=only_contigs,
            inflate_device=card)
        get_logger().info("ingest backend: native")
        return store, "native"
    except Exception as e:  # NativeUnavailable or build/runtime failure
        if card is not None:
            raise
        get_logger().warning("native ingest unavailable (%s); using Python reader", e)
        return load_read_store(cfg.bam, only_contigs=only_contigs), "python"


# the stage artifacts, under OUTPUT/
_PILEUP_VCF = os.path.join("snp_calling", "pileup.vcf.gz")
_SV_VCF = os.path.join("sv_calling", "variants.vcf")


def _write_snp_artifact(cfg: PipelineConfig, snps: dict[str, ContigSnps],
                        lengths: dict[str, int]) -> None:
    """The SNP stage's artifact, _PILEUP_VCF, of the calls of every contig
    (a batch run's, the part files' merged, or a streamed run's)."""
    write_pileup_vcf(os.path.join(cfg.output, _PILEUP_VCF), snps, lengths,
                     threads=_writer_threads(cfg))


def _write_sv_artifact(cfg: PipelineConfig, calls: dict[str, list],
                       evidence: dict, lengths: dict[str, int]) -> int:
    """The SV stage's artifact, _SV_VCF: the calls of every contig and the
    breakend pairs clustered over all contigs' breakend evidence at once
    (a junction may pair two contigs).  Returns the number of pairs."""
    bnds = call_bnds(evidence, cfg.sv_cfg())
    write_sv_vcf(os.path.join(cfg.output, _SV_VCF), calls, lengths,
                 family=cfg.sv_caller, bnds=bnds)
    return len(bnds)


def stage_snp_calling(cfg: PipelineConfig, st: PipelineState) -> None:
    """Mirrors ``duet_tpu.pipeline.stage_snp_calling``."""
    os.makedirs(os.path.join(cfg.output, "snp_calling"), exist_ok=True)
    artifact = os.path.join(cfg.output, _PILEUP_VCF)
    if cfg.resume and os.path.exists(artifact):
        get_logger().info("resume: loading %s", artifact)
        st.snps = read_pileup_vcf(artifact)
        return
    # key reference codes by the STORE's contig spelling
    work_fa = _work_contigs(cfg, st.ref.contig_names)
    ref_codes = {}
    for store_name in st.store.contigs:
        for fa_name in work_fa:
            if strip_chr(store_name) == strip_chr(fa_name):
                ref_codes[store_name] = st.ref.fetch_codes(fa_name)
                break
    n_bases = sum(len(st.store.contigs[c].seq) for c in ref_codes)
    st.snps, st.site_obs = call_snps_for_store(
        st.store, ref_codes, cfg.snp_cfg(n_bases), threads=cfg.threads,
        device=cfg.torch_device(), nn_device=cfg.nn_device(), mesh=st.mesh)
    pid, nproc = _proc(cfg)
    if nproc > 1:
        # multi-process: the canonical pileup.vcf.gz is merged and written
        # by process 0 at the final stage
        _dump_part(cfg, "snp", pid, (st.snps, st.store.contig_lengths))
    else:
        _write_snp_artifact(cfg, st.snps, st.store.contig_lengths)
    n = sum(len(s.pos) for s in st.snps.values())
    get_logger().info("called %d SNP sites over %d contigs", n, len(st.snps))


def stage_sv_calling(cfg: PipelineConfig, st: PipelineState) -> None:
    """Mirrors ``duet_tpu.pipeline.stage_sv_calling``."""
    os.makedirs(os.path.join(cfg.output, "sv_calling"), exist_ok=True)
    artifact = os.path.join(cfg.output, _SV_VCF)
    if cfg.resume and os.path.exists(artifact):
        get_logger().info("resume: keeping %s", artifact)
        return
    sv_cfg = cfg.sv_cfg()
    dev = cfg.torch_device()

    def one(item):
        contig, cr = item
        return contig, call_contig_with_evidence(cr, sv_cfg, device=dev,
                                                 mesh=st.mesh)

    work = list(st.store.contigs.items())
    with span("sv_calling.contigs"):
        if cfg.threads > 1 and len(work) > 1 and st.mesh is None:
            # mesh runs go contig-serial: the shards already occupy every
            # device, and serial dispatch keeps them deterministic
            with ThreadPoolExecutor(cfg.threads) as ex:
                results = list(ex.map(one, work))
        else:
            results = list(map(one, work))
    calls = {c: r[0] for c, r in results}
    evidence = {c: r[1] for c, r in results}
    st.sv_calls = calls  # the phasing stage protects their support spans
    n = sum(len(v) for v in calls.values())
    pid, nproc = _proc(cfg)
    if nproc > 1:
        # per-contig calls + breakend evidence travel as a part-file:
        # breakend junctions may pair contigs owned by DIFFERENT processes,
        # so clustering runs globally on process 0 over the merged evidence
        _dump_part(cfg, "sv", pid,
                   (calls, evidence, st.store.contig_lengths))
        get_logger().info("clustered %d SV candidates (part %d/%d)",
                          n, pid, nproc)
        return
    n_bnds = _write_sv_artifact(cfg, calls, evidence,
                                st.store.contig_lengths)
    get_logger().info("clustered %d SV candidates + %d breakend pairs",
                      n, n_bnds)


def _phase_kwargs(cfg: PipelineConfig, st: PipelineState, cr,
                  obs) -> dict:
    """The keyword arguments of ``phase_contig`` and ``phase_contig_core``
    for the contig `cr` with its at-site observations `obs`, from the
    flags and from the run's SV calls.  Under a mesh, which is an opt-in
    (duet_tpu's), phasing uses the device kernels whenever they are
    allowed (not under --host-kernel)."""
    use_device = cfg.use_device_kernel if st.mesh is not None \
        else cfg.stages_on_device()
    return dict(use_device=use_device, obs=obs,
                min_junction_evidence=cfg.min_junction_evidence,
                device_min_nnz=cfg.phasing_device_min_nnz(),
                adaptive_junction_split=cfg.adaptive_junction_split,
                protect_intervals=_sv_protect_intervals(cfg, st, cr),
                device=cfg.torch_device())


def _write_phased(cfg: PipelineConfig, st: PipelineState, cr,
                  snps: ContigSnps, result: PhaseResult) -> None:
    """A phased contig's outputs: its read-hap map in st.read_haps, and in
    snp_phasing/ its phased SNP VCF and its haplotag table."""
    out_dir = os.path.join(cfg.output, "snp_phasing")
    st.read_haps[cr.contig] = read_hap_map(cr, result)
    write_phased_snp_vcf(
        os.path.join(out_dir, f"phased_{cr.contig}.vcf.gz"), cr.contig,
        snps, result, threads=_writer_threads(cfg))
    _write_haplotag_table(
        os.path.join(out_dir, f"{cr.contig}.haplotags.tsv"),
        st.read_haps[cr.contig])


def stage_snp_phasing(cfg: PipelineConfig, st: PipelineState) -> None:
    """Mirrors ``duet_tpu.pipeline.stage_snp_phasing``: the refine/correct
    loop per contig (thread pool, each contig behind its own nnz gate),
    then the read scoring of all contigs in one batch, on the device when
    their combined nnz clears the gate (``score_contigs_batched``); under
    a mesh, ``phase_contig`` on the mesh contig by contig."""
    out_dir = os.path.join(cfg.output, "snp_phasing")
    os.makedirs(out_dir, exist_ok=True)
    if cfg.resume and not st.sv_calls:
        # resumed run: the calls the protection intervals need live only in
        # the artifact; parse it once, keyed by the store's contig spellings
        variants = os.path.join(cfg.output, _SV_VCF)
        if os.path.exists(variants):
            parsed = parse_sv_vcf(variants, True)
            for c in st.store.contigs:
                for key in (c, strip_chr(c), "chr" + strip_chr(c)):
                    if key in parsed:
                        st.sv_calls[c] = parsed[key]
                        break
    work = [(st.store.contigs[c], s) for c, s in st.snps.items()
            if c in st.store.contigs]
    if st.mesh is not None:
        scored = {
            cr.contig: phase_contig(
                cr, s, cfg.snp_cfg(), mesh=st.mesh, mode=cfg.haplotag_mode(),
                **_phase_kwargs(cfg, st, cr, st.site_obs.get(cr.contig)))
            for cr, s in work}
    else:
        def core(item):
            cr, snps = item
            return cr.contig, phase_contig_core(
                cr, snps, cfg.snp_cfg(),
                **_phase_kwargs(cfg, st, cr, st.site_obs.get(cr.contig)))

        with span("snp_phasing.refine"):
            if cfg.threads > 1 and len(work) > 1:
                with ThreadPoolExecutor(cfg.threads) as ex:
                    cores = dict(ex.map(core, work))
            else:
                cores = dict(map(core, work))
        with span("snp_phasing.score"):
            scored = score_contigs_batched(
                cores, cfg.stages_on_device(),
                cfg.phasing_device_min_nnz(), cfg.torch_device(),
                mode=cfg.haplotag_mode())
    for cr, snps in work:
        result = scored[cr.contig]
        st.phase_results[cr.contig] = result
        _write_phased(cfg, st, cr, snps, result)
        if cfg.haplotag_bam:
            _write_haplotag_bam(
                os.path.join(out_dir, f"{cr.contig}.bam"), cr,
                st.read_haps[cr.contig], st.store.contig_lengths,
                threads=_writer_threads(cfg))
        n_reads = len(result.row_names) if result.row_names else cr.n
        get_logger().info(
            "[PHASING] %s: %d het sites, %d blocks, %d/%d reads tagged",
            cr.contig, len(result.site_pos), len(result.block_ps),
            int((result.read_hap != 0).sum()), n_reads)


def _bam_order(cfg: PipelineConfig, d: dict) -> dict:
    """Reorder a per-contig dict to the BAM header's contig order — the
    order a single-process run iterates in, so merged multi-process
    artifacts stay byte-identical (lexicographic sort would swap e.g.
    chr10 before chr2)."""
    from duet_tpu_torch.io.bam import BamReader

    with BamReader(cfg.bam) as r:
        rank = {n: i for i, n in enumerate(r.header.ref_names)}
    return dict(sorted(d.items(), key=lambda kv: rank.get(kv[0], len(rank))))


def _merge_parts_and_write(cfg: PipelineConfig, nproc: int) -> None:
    """Process 0: fuse every part-file into the canonical single-process
    artifacts (pileup.vcf.gz, variants.vcf incl. globally clustered
    breakends) — from here on the final stage is identical to a
    single-process run."""
    snps: dict = {}
    lengths: dict[str, int] = {}
    for part_snps, part_lengths in _load_parts(cfg, "snp", nproc):
        snps.update(part_snps)
        lengths.update(part_lengths)
    _write_snp_artifact(cfg, _bam_order(cfg, snps), lengths)

    calls: dict = {}
    evidence: dict = {}
    for part_calls, part_ev, part_lengths in _load_parts(cfg, "sv", nproc):
        calls.update(part_calls)
        evidence.update(part_ev)
        lengths.update(part_lengths)
    n_bnds = _write_sv_artifact(cfg, _bam_order(cfg, calls), evidence,
                                lengths)
    get_logger().info(
        "merged %d part(s): %d contigs, %d breakend pairs", nproc,
        len(calls), n_bnds,
    )


def _sv_phasing_inputs(cfg: PipelineConfig, st: PipelineState,
                       variants: str) -> tuple[dict, dict]:
    """The SV calls of `variants` by chromosome, and each chromosome's
    read-hap map under the parser's name (tables from snp_phasing/ for the
    chromosomes this run did not phase)."""
    # -a contig list comes from the SNP-calling artifact when present, as
    # the reference's `tabix --list-chroms` on pileup.vcf.gz
    chrom_list = None
    if cfg.include_all_ctgs:
        pileup = os.path.join(cfg.output, _PILEUP_VCF)
        if os.path.exists(pileup):
            from duet_tpu_torch.io.vcf import list_chroms

            chrom_list = list_chroms(pileup)
    per_chrom = parse_sv_vcf(variants, cfg.include_all_ctgs,
                             chrom_list=chrom_list)
    have = {strip_chr(c) for c in st.read_haps}
    missing = [c for c in per_chrom if strip_chr(c) not in have]
    if missing:
        from duet_tpu_torch.io.haplotag_bam import read_hap_tables_from_dir

        st.read_haps.update(read_hap_tables_from_dir(
            os.path.join(cfg.output, "snp_phasing"), missing))
    # align read-hap map keys to the parser's canonical names
    read_haps = {}
    for name in per_chrom:
        for contig, m in st.read_haps.items():
            if contig == name or strip_chr(contig) == strip_chr(name):
                read_haps[name] = m
                break
    return per_chrom, read_haps


def stage_sv_phasing(cfg: PipelineConfig, st: PipelineState) -> None:
    """Mirrors ``duet_tpu.pipeline.stage_sv_phasing``, with the decision
    pass on the device when ``decide_on_device``.  In a multi-process run
    every process meets at a barrier, and process 0 alone merges the parts
    and writes the final artifacts."""
    pid, nproc = _proc(cfg)
    if nproc > 1:
        _barrier(cfg, "pre-merge")
        if pid != 0:
            return  # single-writer emission on process 0 (SURVEY.md §5.8)
        _merge_parts_and_write(cfg, nproc)
    variants = os.path.join(cfg.output, _SV_VCF)
    artifact = os.path.join(cfg.output, "phased_sv.vcf")
    if not os.path.exists(variants):
        raise FileNotFoundError(f"sv_calling artifact missing: {variants}")
    with span("sv_phasing.parse"):
        per_chrom, read_haps = _sv_phasing_inputs(cfg, st, variants)
    n_calls = sum(len(v) for v in per_chrom.values())
    with span("sv_phasing.decide"):
        phased = phase_callset(
            per_chrom, read_haps, cfg.sv_min_size, cfg.min_support_read,
            use_device=cfg.decide_on_device(n_calls),
            phase_bnd=cfg.phase_bnd, decision_model=cfg.decision_model,
            device=cfg.torch_device())
    write_phased_sv_header(variants, artifact, cfg.include_all_ctgs)
    append_phased_sv_records(phased, artifact)
    get_logger().info("phased %d SV calls -> %s", len(phased), artifact)


STAGES = (
    ("SNP CALLING", stage_snp_calling),
    ("SV CALLING", stage_sv_calling),
    ("SNP PHASING", stage_snp_phasing),
    ("SV PHASING", stage_sv_phasing),
)
# metrics.json's "stages": each stage span's seconds (utils.spans)
STAGE_KEYS = ("ingest",) + tuple(stage_key(name) for name, _ in STAGES)


def _open_log(cfg: PipelineConfig, pid: int = 0) -> None:
    """OUTPUT/ and the run's log in it (run_duet.p{pid}.log on process
    pid > 0)."""
    os.makedirs(cfg.output, exist_ok=True)
    setup_logging(cfg.output, file_name="run_duet.log" if pid == 0
                  else f"run_duet.p{pid}.log")


def _open_run(cfg: PipelineConfig, pid: int = 0, nproc: int = 1
              ) -> tuple[PipelineState, Future | None, float]:
    """A run's prologue: the log (``_open_log``), a fresh span registry,
    the run state with its mesh, and the card started beside ingest
    (``_start_card``).  Returns (state, card, start time)."""
    _open_log(cfg, pid)
    if nproc > 1:
        get_logger().info("multi-process run: process %d of %d", pid, nproc)
    t0 = time.time()
    spans.reset()
    st = PipelineState()
    st.mesh = _resolve_mesh(cfg)
    return st, _start_card(cfg), t0


def _close_run(card: Future | None, t0: float) -> float:
    """A run's end: join the card's start (raising its error); returns
    the run's seconds."""
    if card is not None:
        card.result()
    return round(time.time() - t0, 4)


def _write_metrics(cfg: PipelineConfig, st: PipelineState, total: float,
                   metrics: dict, pid: int = 0) -> None:
    """Write OUTPUT/metrics.json (metrics.p{pid}.json on process pid > 0):
    the entry's own keys in `metrics`, with the ingest backend in its
    "ingest" and the reads and contigs in its "counts", and the blocks
    every entry writes."""
    # labels reflect what actually ran (invocation counts), not the flags
    snap = dispatch.snapshot()
    traced = spans.snapshot()
    if metrics["ingest"]["backend"] == "native":
        from duet_tpu_torch.io.native_ingest import decode_stats

        native = decode_stats()
        if native is not None:
            metrics["ingest"]["native"] = native
    metrics["counts"]["snp_sites"] = sum(len(s.pos) for s in st.snps.values())
    metrics["counts"]["tagged_reads"] = sum(
        len(m) for m in st.read_haps.values())
    dev = cfg.torch_device()
    metrics.update({
        "backends": {s: dispatch.backend_label(s, snap)
                     for s in dispatch.LABELED},
        "device_dispatch": snap,
        "device_cost": devcost.snapshot(),
        # the device the run was configured for
        "device": {
            "type": dev.type,
            "name": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" and torch.cuda.is_available() else None,
        },
        "stages": {k: round(traced["spans"].get(k, {}).get("s", 0.0), 4)
                   for k in STAGE_KEYS},
        "total_s": total,
        "peak_rss_mb": _peak_rss_mb(),
        **spans.rounded(traced),
    })
    if cfg.device_stages == "auto":
        metrics["device_size_gates"] = cfg.device_size_gates()
    name = "metrics.json" if pid == 0 else f"metrics.p{pid}.json"
    with open(os.path.join(cfg.output, name), "w") as f:
        json.dump(metrics, f, indent=2)


def run_pipeline_streaming(cfg: PipelineConfig) -> str:
    """Contig-major streaming run for memory-bounded whole-genome inputs;
    mirrors ``duet_tpu.pipeline.run_pipeline_streaming`` (no compile
    cache).

    Instead of decoding the whole BAM up front, each coordinate-sorted
    contig is decoded, SNP-called, SV-called, phased and haplotagged, then
    released: peak memory is one contig's reads (two while the next contig
    decodes ahead).  The final cross-contig SV-phasing stage runs once at
    the end.  Output artifacts are identical to run_pipeline's.  The device
    routes follow ``stages_on_device``, and each contig's reads are scored
    on their own (``phase_contig``), not batched across contigs; under a
    mesh each stage runs on it as in the batch run."""
    from duet_tpu_torch.io.readstore import (
        prefetch_iter,
        stream_contig_reads_auto,
    )

    if (cfg.num_processes or 1) > 1:
        raise ValueError("--stream does not combine with multi-process runs; "
                         "use one mode or the other")
    dev = cfg.torch_device()
    check_envs(cfg)
    st, card, t0 = _open_run(cfg)
    log = get_logger()
    st.ref = FastaFile(cfg.reference)
    for d in ("snp_calling", "sv_calling", "snp_phasing"):
        os.makedirs(os.path.join(cfg.output, d), exist_ok=True)

    aliases = {}
    for canonical in _work_contigs(cfg, st.ref.contig_names):
        aliases[canonical] = canonical
        aliases[strip_chr(canonical)] = canonical
        aliases["chr" + strip_chr(canonical)] = canonical

    bnd_evidence: dict = {}
    lengths: dict[str, int] = {}
    n_reads = 0
    # each stage is a span opened once a contig; the RSS high-water mark
    # right after each stage (ru_maxrss is monotone: the stage where a
    # value first jumps is where the peak formed)
    stage_rss = dict.fromkeys(STAGE_KEYS, 0.0)

    def _mark(stage: str) -> None:
        stage_rss[stage] = max(stage_rss[stage], _peak_rss_mb())

    stream, stream_backend = stream_contig_reads_auto(
        cfg.bam, n_threads=cfg.threads,
        inflate_device=cfg.inflate_device())
    # contig N+1 decodes on a background thread while the stages process
    # contig N ("ingest" below is then the stall waiting for the decode);
    # only with spare cores, where the two do not just time-slice
    try:
        n_cores = len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        n_cores = os.cpu_count() or 1
    prefetch = n_cores >= 4
    if prefetch:
        stream = prefetch_iter(stream, depth=1)
    log.info("streaming ingest backend: %s%s", stream_backend,
             " (prefetch depth 1)" if prefetch else "")
    with StageTimer("STREAMING CONTIG PASS"):
        contigs = iter(stream)
        while True:
            with span("ingest"):  # generator time = decode time
                item = next(contigs, None)
            _mark("ingest")
            if item is None:
                break
            cr, contig_lengths = item
            del item
            if cr.contig not in aliases:
                del cr
                continue
            if cr.contig in st.snps:
                # a repeated contig means the BAM is not coordinate-sorted;
                # the first segment's results are already released, so
                # keeping the last would drop reads
                raise ValueError(
                    f"--stream requires a coordinate-sorted BAM: contig "
                    f"{cr.contig} appears in multiple stream segments; "
                    "run without --stream (batch mode merges segments)"
                )
            lengths.update(contig_lengths)
            n_reads += cr.n
            fa_name = aliases[cr.contig]
            if fa_name not in st.ref.index:
                fa_name = cr.contig
            with span("ingest"):  # reference load is ingest, not SNP calling
                codes = st.ref.fetch_codes(fa_name)
            _mark("ingest")
            with span("snp_calling"):
                snps, site_obs = call_snps_for_contig(
                    cr.contig, cr, codes,
                    cfg.snp_cfg(len(cr.seq), stream=True), dev,
                    cfg.nn_device(), st.mesh)
                st.snps[cr.contig] = snps
            _mark("snp_calling")
            # cross-contig breakend evidence survives the contig's release
            with span("sv_calling"), span("sv_calling.contigs"):
                st.sv_calls[cr.contig], bnd_evidence[cr.contig] = \
                    call_contig_with_evidence(cr, cfg.sv_cfg(), device=dev,
                                              mesh=st.mesh)
            _mark("sv_calling")
            with span("snp_phasing"):
                result = phase_contig(
                    cr, snps, cfg.snp_cfg(), mesh=st.mesh,
                    mode=cfg.haplotag_mode(),
                    **_phase_kwargs(cfg, st, cr, site_obs))
                _write_phased(cfg, st, cr, snps, result)
            _mark("snp_phasing")
            log.info("[STREAM] %s: %d reads, %d SNPs, %d SV candidates, "
                     "%d blocks", cr.contig, cr.n, len(snps.pos),
                     len(st.sv_calls[cr.contig]), len(result.block_ps))
            st.ref.drop_cache(fa_name)
            # drop this contig before the next one decodes beside it
            del cr, codes, site_obs, result
    _write_snp_artifact(cfg, st.snps, lengths)
    _write_sv_artifact(cfg, st.sv_calls, bnd_evidence, lengths)
    with StageTimer("SV PHASING"):
        stage_sv_phasing(cfg, st)
    _mark("sv_phasing")
    total = _close_run(card, t0)
    log.info("ALL STAGES COMPLETED IN %ss (streamed %d reads)", total, n_reads)
    _write_metrics(cfg, st, total, {
        "mode": "streaming",
        "ingest_backend": stream_backend,
        "ingest": {"backend": stream_backend},
        "stage_peak_rss_mb": {k: round(v, 1) for k, v in stage_rss.items()},
        "counts": {
            "reads": n_reads,
            "contigs": len(st.snps),
            "sv_candidates": sum(len(v) for v in st.sv_calls.values()),
        },
        "reads_per_s": round(n_reads / max(total, 1e-9), 1),
    })
    return os.path.join(cfg.output, "phased_sv.vcf")


def pileup_observations_for(cr, cfg: PipelineConfig):
    """Mirrors ``duet_tpu.pipeline.pileup_observations_for``."""
    from duet_tpu_torch.models.snp_caller_host import pileup_observations

    return pileup_observations(cr, cfg.snp_cfg())


def run_phase_only(cfg: PipelineConfig) -> str:
    """Final stage only, from on-disk artifacts; mirrors
    ``duet_tpu.pipeline.run_phase_only``.

    OUTPUT must hold sv_calling/variants.vcf (any supported caller format)
    and snp_phasing/ with either .haplotags.tsv tables or reference-style
    haplotagged per-chromosome BAMs carrying HP/PC/PS tags, so reference
    users can re-phase their existing intermediates."""
    if (cfg.num_processes or 1) > 1:
        raise ValueError("--phase-only is a single-process mode")
    _open_log(cfg)
    st = PipelineState()
    with StageTimer("SV PHASING"):
        stage_sv_phasing(cfg, st)
    return os.path.join(cfg.output, "phased_sv.vcf")


def run_pipeline(cfg: PipelineConfig) -> str:
    """Run all stages; returns the phased_sv.vcf path.  Mirrors
    ``duet_tpu.pipeline.run_pipeline`` (no compile cache); OUTPUT/
    metrics.json (metrics.p{pid}.json on process pid > 0) keeps its schema
    and adds the device the run was configured for."""
    check_envs(cfg)
    if cfg.coordinator is not None:
        from duet_tpu_torch.parallel.distributed import init_distributed

        init_distributed(cfg.coordinator, cfg.num_processes, cfg.process_id)
    pid, nproc = _proc(cfg)
    if nproc > 1 and cfg.resume:
        raise ValueError("--resume does not combine with multi-process runs: "
                         "stage outputs live in part files, not the "
                         "single-process artifacts resume checks")
    st, card, t0 = _open_run(cfg, pid, nproc)
    log = get_logger()
    with StageTimer("INGEST") as ingest:
        with span("ingest.fasta_index") as fasta:
            st.ref = FastaFile(cfg.reference)
        owned = None
        if nproc > 1:
            from duet_tpu_torch.io.bam import BamReader

            with BamReader(cfg.bam) as r:
                bam_names = list(r.header.ref_names)
            work = _work_contigs(cfg, bam_names)
            owned = set(_owned_contigs(work, pid, nproc))
            log.info("owned contigs: %s", sorted(owned))
        with span("ingest.bam_decode") as bam:
            st.store, ingest_backend = _ingest(cfg, only_contigs=owned)
        n_reads = sum(c.n for c in st.store.contigs.values())
        log.info("ingested %d reads over %d contigs", n_reads,
                 len(st.store.contigs))
    metrics = {
        "counts": {"reads": n_reads, "contigs": len(st.store.contigs)},
        "ingest": {
            "backend": ingest_backend,
            "fasta_index_s": round(fasta.s, 4),
            "bam_decode_s": round(bam.s, 4),
            "bam_decode_reads_per_s": round(n_reads / max(bam.s, 1e-9), 1),
        },
        "ingest_reads_per_s": round(n_reads / max(ingest.s, 1e-9), 1),
    }
    for name, fn in STAGES:
        with StageTimer(name):
            fn(cfg, st)
    if st.mesh is not None:
        metrics["mesh"] = {"dp": int(st.mesh.shape["dp"]),
                           "sp": int(st.mesh.shape["sp"])}
    total = _close_run(card, t0)
    _write_metrics(cfg, st, total, metrics, pid)
    log.info("ALL STAGES COMPLETED IN %ss", total)
    log.info("OUTPUT: %s", os.path.join(cfg.output, "phased_sv.vcf"))
    return os.path.join(cfg.output, "phased_sv.vcf")
