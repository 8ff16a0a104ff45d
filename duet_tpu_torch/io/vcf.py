"""VCF parsing and emission.

Parsing mirrors the caller-agnostic SV-VCF semantics of the reference
(src/duet/read_file.py:25-77): SVLEN/SVTYPE from INFO (SVLEN missing or '.'
-> 0, 'SVLEN=>' form handled), support-read count from SUPPORT=/SR=/RE=,
read names from RNAMES=/READS=, genotype + ref/var read-depths from the
FORMAT/sample column across the three caller layouts (>4 fields: GT:DR:DV:…;
3-4 fields with comma-packed 'DR,DV' last field; plain 3-field GT:DR:DV).

Emission covers: the phased_sv.vcf writer with byte-parity to
src/duet/write_file.py (header layout incl. the 'FORMAT\tVALUE' column line,
Duet.<idx> IDs, 'SVTYPE=<T>' INFO form), plus pileup-VCF and caller-VCF
writers for the in-framework SNP/SV callers.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field

from duet_tpu_torch.io.bgzf import BgzfReader, BgzfWriter, is_bgzf
from duet_tpu_torch.utils.chrom import matches_chrom, resolve_contig_names
from duet_tpu_torch.utils.spans import span


def open_maybe_gzip(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        if "r" in mode and is_bgzf(path):
            import io as _io
            return _io.TextIOWrapper(BgzfReader(path))
        return gzip.open(path, mode)
    return open(path, mode)


def read_vcf_lines(path: str) -> list[list[str]]:
    """All lines, whitespace-split (reference read_file.py:18-23 keeps header
    lines too; callers filter by the leading column)."""
    with open_maybe_gzip(path) as f:
        return [line.split() for line in (s.strip() for s in f) if line]


def list_chroms(vcf_gz_path: str) -> list[str]:
    """Unique data-line contigs in file order — `tabix --list-chroms`
    equivalent (reference snp_phasing.py:17, read_file.py:15) without
    requiring a .tbi sidecar."""
    seen: list[str] = []
    have = set()
    with open_maybe_gzip(vcf_gz_path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            c = line.split("\t", 1)[0].split(" ", 1)[0]
            if c not in have:
                have.add(c)
                seen.append(c)
    return seen


@dataclass
class SVRecord:
    """One SV call with the enrichment columns the reference appends
    (read_file.py:34-76 cols 10..16)."""

    chrom: str
    pos: int
    call_id: str
    ref: str
    alt: str
    qual: str
    filt: str
    info: str
    fmt: str
    sample: str
    svlen: int = 0          # signed, as parsed (col 10)
    svtype: str = ""        # col 11
    support: int = 0        # col 12 (SUPPORT=/SR=/RE=)
    read_names: list[str] = field(default_factory=list)  # col 13
    gt: str = ""            # col 14
    ref_reads: int = 0      # col 15
    var_reads: int = 0      # col 16
    # filled by the phasing stage join: per-read [hap, ps, pc] or None
    read_haps: list = field(default_factory=list)


def _info_field(info_parts: list[str], keys: tuple[str, ...]) -> str | None:
    for part in info_parts:
        if any(k in part for k in keys):
            return part
    return None


def _parse_one_sv(cols: list[str]) -> SVRecord:
    rec = SVRecord(
        chrom=cols[0], pos=int(cols[1]), call_id=cols[2], ref=cols[3],
        alt=cols[4], qual=cols[5], filt=cols[6], info=cols[7],
        fmt=cols[8] if len(cols) > 8 else "",
        sample=cols[9] if len(cols) > 9 else "",
    )
    info_parts = rec.info.split(";")

    svlen = _info_field(info_parts, ("SVLEN=",))
    if svlen is None or svlen == "SVLEN=.":
        rec.svlen = 0
    elif ">" in svlen:  # 'SVLEN=>123' form (read_file.py:36)
        rec.svlen = int(svlen[7:])
    else:
        rec.svlen = int(svlen[6:])

    svtype = _info_field(info_parts, ("SVTYPE=",))
    rec.svtype = svtype[7:] if svtype else ""

    supp = _info_field(info_parts, ("SUPPORT=", "SR=", "RE="))
    if supp is not None:
        rec.support = int(supp[8:]) if "SUPPORT=" in supp else int(supp[3:])

    rname = _info_field(info_parts, ("RNAMES=", "READS="))
    if rname is not None:
        rec.read_names = (rname[7:] if "RNAMES=" in rname else rname[6:]).split(",")

    def _count(x: str) -> int:
        # the reference maps '.' to 0 and would crash on anything else
        # (read_file.py:59-76); tolerate other non-numeric junk (e.g. a
        # stray comma-packed value in a middle field) as 0 — identical on
        # every input the reference survives, graceful where it dies
        try:
            return int(x)
        except ValueError:
            return 0

    gtinfo = rec.sample.split(":")
    if len(gtinfo) > 4:  # e.g. cuteSV GT:DR:DV:PL:GQ (read_file.py:57-62)
        rec.gt = gtinfo[0]
        rec.ref_reads = _count(gtinfo[1])
        rec.var_reads = _count(gtinfo[2])
    elif len(gtinfo) >= 3:  # (read_file.py:63-76)
        rec.gt = gtinfo[0]
        last = gtinfo[-1]
        if "," not in last:
            rec.ref_reads = _count(gtinfo[1])
            rec.var_reads = _count(gtinfo[2])
        else:  # comma-packed 'DR,DV' (e.g. SVIM AD field)
            dr, dv = last.split(",", 1)
            rec.ref_reads = _count(dr)
            rec.var_reads = _count(dv)
    return rec


def parse_sv_vcf(path: str, include_all_ctgs: bool, chrom_list: list[str] | None = None) -> dict[str, list[SVRecord]]:
    """Parse a base-caller SV VCF into per-canonical-chromosome record lists.

    Mirrors reference parse_vcf (read_file.py:25-77): records are grouped by
    canonical name accepting both 'chrN'/'N' spellings; contigs outside the
    work list are dropped. NOTE unlike the reference (which probes column
    layout once per chromosome from the first record), layout is resolved
    per record — identical results for homogeneous caller output.
    """
    lines = read_vcf_lines(path)
    data = [c for c in lines if c and not c[0].startswith("#")]
    if chrom_list is None:
        present = []
        for c in data:
            if c[0] not in present:
                present.append(c[0])
        chrom_list = resolve_contig_names(present, include_all_ctgs)
    out: dict[str, list[SVRecord]] = {name: [] for name in chrom_list}
    for cols in data:
        for name in chrom_list:
            if matches_chrom(cols[0], name):
                out[name].append(_parse_one_sv(cols))
                break
    return out


# ----------------------------------------------------------------------------
# Emission
# ----------------------------------------------------------------------------

PHASED_SV_HEADER_BODY = """##fileformat=VCFv4.2
##source=Duet
##ALT=<ID=INS,Description="Insertion of novel sequence relative to the reference">
##ALT=<ID=DEL,Description="Deletion relative to the reference">
##FILTER=<ID=PASS,Description="SV calls passed phasing criterion">
##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="Estimated length of the variant">
##FORMAT=<ID=HP,Number=1,Type=String,Description="Haplotype of the SV call">
##FORMAT=<ID=PS,Number=1,Type=String,Description="Phase set which the SV call belongs to">
"""

PHASED_SV_COLUMNS = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tVALUE\n"


@span("write.phased_sv_vcf")
def write_phased_sv_header(caller_vcf_path: str, output_path: str, include_all_ctgs: bool) -> None:
    """Byte-parity with reference print_sv_header (write_file.py:19-45):
    fixed meta lines, then ##contig lines copied from the base caller VCF
    filtered to the chromosome work list, then the FORMAT\\tVALUE column line."""
    header = PHASED_SV_HEADER_BODY
    lines = read_vcf_lines(caller_vcf_path)
    if not include_all_ctgs:
        from duet_tpu_torch.utils.chrom import standard_chrom_names
        for name in standard_chrom_names():
            for cols in lines:
                if f"##contig=<ID=chr{name}," in cols[0] or f"##contig=<ID={name}," in cols[0]:
                    header += cols[0] + "\n"
    else:
        for cols in lines:
            if "##contig=<ID=" in cols[0]:
                header += cols[0] + "\n"
    header += PHASED_SV_COLUMNS
    with open(output_path, "w") as f:
        f.write(header)


@span("write.phased_sv_vcf")
def append_phased_sv_records(phased_callset: list[dict], output_path: str) -> None:
    """Byte-parity with reference print_sv (write_file.py:6-17): Duet.<idx>
    IDs starting at 1, 'SVLEN=<signed>;SVTYPE=<T>' INFO, HP:PS genotype."""
    with open(output_path, "a") as f:
        for idx, c in enumerate(phased_callset, start=1):
            f.write(
                f"{c['chrom']}\t{c['pos']}\tDuet.{idx}\t{c['ref']}\t{c['alt']}"
                f"\t.\tPASS\tSVLEN={c['svlen']};SVTYPE=<{c['svtype']}>\tHP:PS\t"
                f"{c['hp']}:{c['ps']}\n"
            )


def write_vcf(path: str, header_lines: list[str], records: list[str],
              index: bool = True) -> None:
    """Generic VCF writer; BGZF-compresses when path ends with .gz and
    tabix-indexes the result (artifact parity with the reference's
    `tabix -f -p vcf` step, snp_phasing.py:25) — records must be
    coordinate-sorted per contig, which every in-framework emitter is."""
    text = "\n".join(header_lines + records) + "\n"
    if path.endswith(".gz"):
        with BgzfWriter(path) as w:
            w.write(text.encode())
        if index:
            from duet_tpu_torch.io.tabix import write_tabix_index

            write_tabix_index(path)
    else:
        with open(path, "w") as f:
            f.write(text)
