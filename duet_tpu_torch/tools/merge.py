"""``duet_tpu.tools.merge``, copied for the port: verbatim but for its imports
(the VCF header keeps duet_tpu's ``##source``, so both packages write the
same bytes).

Multi-sample merge of phased SV callsets (trio / cohort runs).

Each sample runs the pipeline independently (one BAM -> one phased_sv.vcf,
shardable across hosts); this tool unifies the per-sample callsets into one
multi-sample VCF: calls are matched across samples with the same criteria
the evaluation harness uses (same chrom + SV type, position distance <=
refdist, reciprocal length ratio >= pctsim), and each merged record carries
one HP:PS column per sample ('./.' where a sample lacks the call).

CLI:  python -m duet_tpu_torch.tools.merge A.vcf B.vcf C.vcf \
          -o trio.vcf --names HG002 HG003 HG004 [-r 1000] [-p 0.0]
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field

import numpy as np

from duet_tpu_torch.io.vcf import open_maybe_gzip


@dataclass
class _Call:
    chrom: str
    pos: int
    ref: str
    alt: str
    svtype: str
    svlen: int      # signed
    hp: str
    ps: str
    sample: int


def _load_phased(path: str, sample: int) -> list[_Call]:
    out = []
    with open_maybe_gzip(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            svlen, svtype = 0, ""
            for part in cols[7].split(";"):
                if part.startswith("SVLEN="):
                    svlen = int(part[6:])
                elif part.startswith("SVTYPE="):
                    svtype = part[7:].strip("<>")
            sample_col = cols[9] if len(cols) > 9 else ""
            hp, _, ps = sample_col.partition(":")
            out.append(_Call(cols[0], int(cols[1]), cols[3], cols[4],
                             svtype, svlen, hp or "./.", ps or ".", sample))
    return out


def merge_callsets(per_sample: list[list[_Call]], refdist: int = 1000,
                   pctsim: float = 0.0) -> list[list[_Call | None]]:
    """Greedy cross-sample clustering -> rows of per-sample slots."""
    n_samples = len(per_sample)
    allc = [c for calls in per_sample for c in calls]
    allc.sort(key=lambda c: (c.chrom, c.svtype, c.pos))
    rows: list[list[_Call | None]] = []
    cur: list[_Call | None] | None = None
    cur_key = None
    cur_anchor: _Call | None = None
    for c in allc:
        key = (c.chrom, c.svtype)
        match = False
        if cur is not None and key == cur_key and cur_anchor is not None:
            d = abs(c.pos - cur_anchor.pos)
            la, lb = abs(c.svlen), abs(cur_anchor.svlen)
            ratio = min(la, lb) / max(la, lb) if max(la, lb) else 1.0
            match = d <= refdist and ratio >= pctsim and cur[c.sample] is None
        if match:
            cur[c.sample] = c
        else:
            cur = [None] * n_samples
            cur[c.sample] = c
            cur_key = key
            cur_anchor = c
            rows.append(cur)
    rows.sort(key=lambda r: (next(c for c in r if c).chrom,
                             next(c for c in r if c).pos))
    return rows


def write_merged(rows, names: list[str], out_path: str) -> None:
    with open(out_path, "w") as f:
        f.write("##fileformat=VCFv4.2\n##source=duet_tpu.merge\n")
        f.write('##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="SV length">\n')
        f.write('##INFO=<ID=SVTYPE,Number=1,Type=String,Description="SV type">\n')
        f.write('##INFO=<ID=NS,Number=1,Type=Integer,Description="Samples with call">\n')
        f.write('##FORMAT=<ID=HP,Number=1,Type=String,Description="Haplotype">\n')
        f.write('##FORMAT=<ID=PS,Number=1,Type=String,Description="Phase set">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(names) + "\n")
        for idx, row in enumerate(rows, start=1):
            anchor = next(c for c in row if c is not None)
            ns = sum(c is not None for c in row)
            cols = [
                anchor.chrom, str(anchor.pos), f"Merged.{idx}", anchor.ref,
                anchor.alt, ".", "PASS",
                f"SVLEN={anchor.svlen};SVTYPE=<{anchor.svtype}>;NS={ns}",
                "HP:PS",
            ] + [f"{c.hp}:{c.ps}" if c else "./.:." for c in row]
            f.write("\t".join(cols) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m duet_tpu_torch.tools.merge")
    p.add_argument("vcfs", nargs="+")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--names", nargs="*", default=None)
    p.add_argument("-r", "--refdist", type=int, default=1000)
    p.add_argument("-p", "--pctsim", type=float, default=0.0)
    args = p.parse_args(argv)
    names = args.names or [f"SAMPLE{i+1}" for i in range(len(args.vcfs))]
    if len(names) != len(args.vcfs):
        p.error("--names count must match the number of VCFs")
    per_sample = [_load_phased(path, i) for i, path in enumerate(args.vcfs)]
    rows = merge_callsets(per_sample, args.refdist, args.pctsim)
    write_merged(rows, names, args.output)
    print(f"merged {sum(len(s) for s in per_sample)} calls from "
          f"{len(names)} samples into {len(rows)} records -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
