"""``duet_tpu.sim.cli_make_demo``, copied for the port: verbatim but for its
imports.

`python -m duet_tpu_torch.sim.cli_make_demo <DIR>` — write a demo dataset.

The offline stand-in for the reference's downloadable HG00733 chr21 demo
(reference README.md:81-92): ref.fa(.fai), reads.bam(.bai), truth.vcf.
"""

from __future__ import annotations

import argparse

from duet_tpu_torch.sim.simulate import SimConfig, simulate_dataset


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cli_make_demo")
    p.add_argument("dir", help="output directory")
    p.add_argument("--length", type=int, default=200_000,
                   help="contig length (default 200k)")
    p.add_argument("--coverage", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--contig", default="chr21")
    args = p.parse_args(argv)
    simulate_dataset(args.dir, SimConfig(
        contigs={args.contig: args.length},
        coverage=args.coverage, seed=args.seed,
    ))
    print(f"demo dataset written to {args.dir}: ref.fa(.fai) reads.bam(.bai) truth.vcf")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
