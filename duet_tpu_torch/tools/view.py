"""``duet_tpu.tools.view``, copied for the port: verbatim but for its imports.

Region viewer over indexed artifacts — the samtools-view / tabix query
surface of the X6 toolchain replacement (SURVEY.md §2.3), backed by the
in-framework .bai/.tbi indexes (random access, not a scan).

CLI:
  python -m duet_tpu_torch.tools.view reads.bam   chr21:10000-20000   # SAM-ish
  python -m duet_tpu_torch.tools.view calls.vcf.gz chr21:10000-20000  # VCF records
"""

from __future__ import annotations

import argparse
import sys

_CIGAR_OPS = "MIDNSHP=X"


def _parse_region(region: str) -> tuple[str, int, int]:
    """chrom[:beg-end] with 1-based inclusive coordinates (samtools style);
    returns 0-based half-open."""
    if ":" not in region:
        return region, 0, 1 << 60
    chrom, _, span = region.partition(":")
    beg_s, _, end_s = span.replace(",", "").partition("-")
    beg = int(beg_s) - 1 if beg_s else 0
    end = int(end_s) if end_s else 1 << 60
    return chrom, max(beg, 0), end


def _cigar_str(cigar) -> str:
    if len(cigar) == 0:
        return "*"
    return "".join(f"{int(ln)}{_CIGAR_OPS[int(op)]}" for op, ln in cigar)


def view_bam(path: str, region: str, out=sys.stdout) -> int:
    from duet_tpu_torch.io.bai import bam_query
    from duet_tpu_torch.io.fasta import decode_bases

    chrom, beg, end = _parse_region(region)
    n = 0
    for rd in bam_query(path, chrom, beg, end):
        seq = decode_bases(rd.seq_codes) if len(rd.seq_codes) else "*"
        qual = "".join(chr(q + 33) for q in rd.quals) if len(rd.quals) else "*"
        tags = "\t".join(
            f"{k}:{'i' if isinstance(v, int) else 'Z'}:{v}"
            for k, v in rd.tags.items()
        )
        line = (f"{rd.name}\t{rd.flag}\t{chrom}\t{rd.pos + 1}\t{rd.mapq}\t"
                f"{_cigar_str(rd.cigar)}\t*\t0\t0\t{seq}\t{qual}")
        out.write(line + ("\t" + tags if tags else "") + "\n")
        n += 1
    return n


def view_vcf(path: str, region: str, out=sys.stdout) -> int:
    from duet_tpu_torch.io.tabix import query

    chrom, beg, end = _parse_region(region)
    lines = query(path, chrom, beg, end)
    for line in lines:
        out.write(line + "\n")
    return len(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m duet_tpu_torch.tools.view")
    p.add_argument("path", help="indexed .bam or .vcf.gz")
    p.add_argument("region", help="chrom[:beg-end], 1-based inclusive")
    p.add_argument("-c", "--count", action="store_true",
                   help="print only the number of records")
    args = p.parse_args(argv)
    import io as _io

    sink = _io.StringIO() if args.count else sys.stdout
    if args.path.endswith(".bam"):
        n = view_bam(args.path, args.region, out=sink)
    else:
        n = view_vcf(args.path, args.region, out=sink)
    if args.count:
        print(n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
