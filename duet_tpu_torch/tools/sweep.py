"""``duet_tpu.tools.sweep``, copied for the port: verbatim but for its imports.
The SV caller stays on the host (``SvCallConfig.device`` defaults to False),
as in duet_tpu.

cluster_max_distance sweep over the span-position linkage (the
clustering-heavy path; BASELINE config 2: "SVIM signatures +
cluster_max_distance sweep").

The BAM is ingested ONCE and signatures are re-clustered per -c value —
the sweep pays one table scan and N cheap segment-reduction passes instead
of N full caller runs (the reference must rerun SVIM per value).

CLI:  python -m duet_tpu_torch.tools.sweep BAM REF.fa OUT_DIR \
          [-c 0.3 0.5 0.7 0.9] [--truth truth.vcf] [-s 50] [-r 2]

Writes OUT_DIR/sweep/variants.c<value>.vcf per point plus a JSON summary
(call counts, and P/R/F1 vs --truth when given) to OUT_DIR/sweep/sweep.json.
"""

from __future__ import annotations

import argparse
import json
import os


def run_sweep(bam: str, reference: str, out_dir: str, values: list[float],
              truth: str | None = None, min_size: int = 50,
              min_support: int = 2) -> dict:
    from duet_tpu_torch.io.readstore import load_read_store
    from duet_tpu_torch.models.sv_caller import call_svs_for_contig
    from duet_tpu_torch.models.sv_caller_host import (
        SvCallConfig,
        contig_tables,
        write_sv_vcf,
    )

    sweep_dir = os.path.join(out_dir, "sweep")
    os.makedirs(sweep_dir, exist_ok=True)
    store = load_read_store(bam)
    # one table scan per contig, shared across every sweep point
    base = SvCallConfig(linkage="span", min_size=min_size,
                        min_support=min_support)
    tables = {c: contig_tables(cr, base) for c, cr in store.contigs.items()}

    summary = {"values": [], "n_calls": [], "vcfs": []}
    if truth:
        summary["calling_f1"] = []
        summary["genotyping_f1"] = []
    for c_val in values:
        cfg = SvCallConfig(linkage="span", cluster_max_distance=c_val,
                           min_size=min_size, min_support=min_support)
        calls = {contig: call_svs_for_contig(cr, cfg, tables[contig])
                 for contig, cr in store.contigs.items()}
        vcf = os.path.join(sweep_dir, f"variants.c{c_val}.vcf")
        write_sv_vcf(vcf, calls, store.contig_lengths, family="svim")
        n = sum(len(v) for v in calls.values())
        summary["values"].append(c_val)
        summary["n_calls"].append(n)
        summary["vcfs"].append(vcf)
        if truth:
            from duet_tpu_torch.eval.evaluate import evaluate_files

            res = evaluate_files(vcf, truth, all_ctgs=True)
            summary["calling_f1"].append(round(res.calling[2], 4))
            summary["genotyping_f1"].append(round(res.genotyping[2], 4))
    with open(os.path.join(sweep_dir, "sweep.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m duet_tpu_torch.tools.sweep")
    p.add_argument("BAM")
    p.add_argument("REFERENCE")
    p.add_argument("OUTPUT")
    p.add_argument("-c", "--values", type=float, nargs="+",
                   default=[0.3, 0.5, 0.7, 0.9])
    p.add_argument("--truth", default=None)
    p.add_argument("-s", "--sv_min_size", type=int, default=50)
    p.add_argument("-r", "--min_support_read", type=int, default=2)
    args = p.parse_args(argv)
    summary = run_sweep(args.BAM, args.REFERENCE, args.OUTPUT, args.values,
                        args.truth, args.sv_min_size, args.min_support_read)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
