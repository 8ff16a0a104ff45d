"""Command-line entry point: `duet-tpu-torch <BAM> <REFERENCE.fa> <OUTPUT_DIR>`.

The flag set of ``duet-tpu`` (its parser is reused) plus ``--device
{cuda,cpu}``, the explicit device of the port's device routes (default
cuda).  Modes the port does not run yet — --stream, --phase-only, --resume,
--mesh, --profile and multi-process runs — raise NotImplementedError
instead of being ignored.
"""

from __future__ import annotations

import argparse
import sys

from duet_tpu import cli as _ref
from duet_tpu_torch.pipeline import PipelineConfig, _not_ported, run_pipeline


def build_parser() -> argparse.ArgumentParser:
    p = _ref.build_parser()
    p.prog = "duet-tpu-torch"
    p.description = ("SNP-assisted structural-variant calling and phasing "
                     "with its device work on PyTorch/CUDA: sorted indexed "
                     "BAM + indexed FASTA -> phased_sv.vcf")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the device routes: cuda (default; fails "
                        "when no GPU is visible) or cpu (the same torch "
                        "code on the host)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.stream:
        raise _not_ported("--stream", "10")
    if args.phase_only:
        raise _not_ported("--phase-only", "10")
    if args.profile:
        raise _not_ported("--profile", "4")
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
    try:
        run_pipeline(cfg)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
