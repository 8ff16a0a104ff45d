"""Command-line entry point: `duet-tpu-torch <BAM> <REFERENCE.fa> <OUTPUT_DIR>`.

The flag set of ``duet-tpu`` (a copy of its parser, help texts included
but for --profile's and --coordinator's, which name torch's tools) plus
``--device {cuda,cpu}``, the explicit device of the port's device routes
(default cuda).  Every mode of duet-tpu runs: the batch run, --resume,
--stream, --phase-only, --mesh, multi-process runs and --profile, which
records the run with torch.profiler into OUTPUT/profile/.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from duet_tpu_torch.pipeline import (
    PipelineConfig,
    run_phase_only,
    run_pipeline,
    run_pipeline_streaming,
)
from duet_tpu_torch.utils import spans


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="duet-tpu-torch",
        description=("SNP-assisted structural-variant calling and phasing "
                     "with its device work on PyTorch/CUDA: sorted indexed "
                     "BAM + indexed FASTA -> phased_sv.vcf"),
    )
    p.add_argument("BAM", help="sorted, indexed BAM of aligned long reads")
    p.add_argument("REFERENCE", help="indexed reference FASTA")
    p.add_argument("OUTPUT", help="output directory")
    p.add_argument("-t", "--threads", type=int, default=4,
                   help="host worker threads (default 4)")
    p.add_argument("-m", "--min_allele_frequency", type=float, default=0.25,
                   help="min allele frequency for SNP calling (default 0.25)")
    p.add_argument("-c", "--cluster_max_distance", type=float, default=0.9,
                   help="span-position cluster distance for the svim-style "
                        "linkage (default 0.9)")
    p.add_argument("-s", "--sv_min_size", type=int, default=50,
                   help="min SV size to call (default 50)")
    p.add_argument("-r", "--min_support_read", type=int, default=2,
                   help="min supporting reads per SV (default 2)")
    p.add_argument("-a", "--include_all_ctgs", action="store_true",
                   help="process all contigs, not just chr1-22/X/Y")
    p.add_argument("-b", "--sv_caller", default="cutesv",
                   choices=["cutesv", "sniffles", "svim"],
                   help="signature-clustering mode: cutesv/sniffles = gap "
                        "linkage, svim = span-position linkage (default cutesv)")
    p.add_argument("--resume", action="store_true",
                   help="skip stages whose artifacts already exist in OUTPUT")
    p.add_argument("--stream", action="store_true",
                   help="contig-major streaming run: bounds memory to one "
                        "contig's reads (whole-genome inputs)")
    p.add_argument("--phase-only", action="store_true",
                   help="run only the final SV-phasing stage from existing "
                        "artifacts in OUTPUT (sv_calling/variants.vcf + "
                        "snp_phasing/ haplotag tables or haplotagged BAMs)")
    p.add_argument("--host-kernel", action="store_true",
                   help="run the decision stage on host (float64) instead of "
                        "the device kernel")
    p.add_argument("--device-stages", default="auto",
                   choices=["auto", "on", "off"],
                   help="route pileup counting and SV clustering through the "
                        "jitted device kernels: auto = when an accelerator "
                        "is live (default), on/off = force")
    p.add_argument("--mesh", default=None, metavar="DP,SP",
                   help="run the phasing/clustering stages sharded over a "
                        "(data-parallel, sequence-parallel) device mesh, "
                        "e.g. --mesh 4,2; 'auto' uses all visible devices "
                        "on the dp axis")
    p.add_argument("--phase-bnd", action="store_true",
                   help="genotype and phase breakend (BND) junctions through "
                        "the decision stage too (the reference filters them "
                        "out with SVLEN<min_size)")
    p.add_argument("--snp-model", default="auto",
                   choices=["auto", "counts", "nn"],
                   help="SNP-calling model: 'auto' (default) picks per "
                        "contig from the data's measured error rate and "
                        "coverage (the nn wins only at >=3.5%% observed "
                        "substitutions and >=7x — the measured grid in "
                        "README); 'counts' is the exact-rational counting "
                        "rule, 'nn' the neural pileup caller "
                        "(models/nn_snp.py — the MXU analogue of Clair3's "
                        "pileup network)")
    p.add_argument("--decision-model", default="verbatim",
                   choices=["verbatim", "learned"],
                   help="genotype/phase decision layer: the reference's "
                        "verbatim T1-T5 tree (default, byte-parity "
                        "contract) or a CART refit on framework features "
                        "from simulation truth (models/decision_model.py "
                        "-- the reference tree's magnitude thresholds were "
                        "tuned on WhatsHap PCs and are dead code on "
                        "framework data, docs/PC_SCALE.md)")
    p.add_argument("--min-junction-evidence", type=float, default=0.0,
                   metavar="E",
                   help="end phase-set blocks at junctions whose converged "
                        "spanning evidence is below the ABSOLUTE threshold "
                        "E (capped at the block's median/20) — explicit "
                        "override of the default adaptive rule "
                        "(docs/PC_SCALE.md). 0 keeps the adaptive rule")
    p.add_argument("--junction-split", default="adaptive",
                   choices=["adaptive", "off"],
                   help="coverage-adaptive weak-junction phase-set "
                        "splitting (default on): split where converged "
                        "junction evidence is a >=20x outlier vs its "
                        "block's median and the spanning reads disagree or "
                        "number <=1 — no absolute scale, so low coverage "
                        "does not backfire (docs/PC_SCALE.md)")
    p.add_argument("--haplotag-bam", action="store_true",
                   help="also write per-contig haplotagged BAMs with "
                        "HP/PC/PS tags (reference artifact parity)")
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler trace of the run into "
                        "OUTPUT/profile/ (Chrome trace JSON with the "
                        "program's spans as ranges: view with Perfetto or "
                        "chrome://tracing), and the card's busy and idle "
                        "seconds by span in idle_by_span.json")
    mh = p.add_argument_group(
        "multi-host", "run one process per host against a shared OUTPUT dir: "
        "contigs are round-robin owned, stage outputs exchanged as part "
        "files, process 0 writes the final artifacts")
    mh.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="torch.distributed (gloo) rendezvous address "
                         "(process 0's)")
    mh.add_argument("--num-processes", type=int, default=None)
    mh.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the device routes: cuda (default; fails "
                        "when no GPU is visible) or cpu (the same torch "
                        "code on the host)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = PipelineConfig(
        bam=args.BAM,
        reference=args.REFERENCE,
        output=args.OUTPUT,
        threads=args.threads,
        min_allele_frequency=args.min_allele_frequency,
        cluster_max_distance=args.cluster_max_distance,
        sv_min_size=args.sv_min_size,
        min_support_read=args.min_support_read,
        include_all_ctgs=args.include_all_ctgs,
        sv_caller=args.sv_caller,
        resume=args.resume,
        use_device_kernel=not args.host_kernel,
        device_stages=args.device_stages,
        mesh=args.mesh,
        haplotag_bam=args.haplotag_bam,
        snp_model=args.snp_model,
        phase_bnd=args.phase_bnd,
        decision_model=args.decision_model,
        min_junction_evidence=args.min_junction_evidence,
        adaptive_junction_split=(args.junction_split == "adaptive"
                                 and args.min_junction_evidence <= 0),
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        device=args.device,
    )
    if not args.profile:
        return _dispatch(args, cfg)
    return _profiled(args, cfg)


def _profiled(args, cfg: PipelineConfig) -> int:
    """The run under torch.profiler — CPU activity, and CUDA activity when
    the run's device is a card — with the Chrome trace written to
    OUTPUT/profile/trace.json (trace.p{pid}.json on process pid > 0, as
    the logs are named), also when the run raises.  The whole run is
    recorded, without shapes or stacks, so the trace stays small at
    chromosome scale.  The program's spans (``utils.spans``) are ranges
    of the trace; once the run ends, idle_by_span.json
    (idle_by_span.p{pid}.json) holds the trace's window, the card's busy
    seconds, and each span's host seconds, the card's busy seconds inside
    it and the idle seconds it owns (``spans.idle_by_span``)."""
    from torch.profiler import ProfilerActivity, profile

    trace_dir = os.path.join(args.OUTPUT, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    pid = cfg.process_id or 0
    suffix = ".json" if pid == 0 else f".p{pid}.json"
    path = os.path.join(trace_dir, "trace" + suffix)
    activities = [ProfilerActivity.CPU]
    if cfg.torch_device().type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, record_shapes=False,
                   with_stack=False)
    try:
        with prof:
            code = _dispatch(args, cfg)
    except BaseException:
        # the run's own error wins over a failed export
        try:
            prof.export_chrome_trace(path)
        except Exception as exc:
            print(f"duet-tpu-torch: profile trace not written: {exc}",
                  file=sys.stderr)
        raise
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    idle = spans.idle_by_span(events, spans.snapshot()["spans"])
    with open(os.path.join(trace_dir, "idle_by_span" + suffix), "w") as f:
        json.dump(idle, f, indent=2)
    return code


def _dispatch(args, cfg: PipelineConfig) -> int:
    """Mirrors ``duet_tpu.cli._dispatch``: phase-only, streaming or batch."""
    try:
        if args.phase_only:
            run_phase_only(cfg)
        elif args.stream:
            run_pipeline_streaming(cfg)
        else:
            run_pipeline(cfg)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
