"""Read per-read HP/PC/PS haplotype tags from a haplotagged BAM.

Drop-in compatibility with the reference data plane: WhatsHap haplotag
writes HP (haplotype 1/2), PC (phasing confidence) and PS (phase set) tags
into per-chromosome BAMs, which the reference's final stage re-parses from
`samtools view` text by POSITION (last three optional tags, keep only if
'PC:i:' appears second-to-last — sv_phasing_fn.py:26-29, flagged fragile in
SURVEY.md §7.3).  Here tags are looked up BY NAME from the binary records
while preserving the same keep-only-if-PC-present join semantics.
"""

from __future__ import annotations

import os

from duet_tpu_torch.io.bam import BamReader


def read_hap_from_bam(path: str) -> dict[str, tuple[int, int, int]]:
    """name -> (hap, ps, pc) for every record carrying all three tags."""
    out: dict[str, tuple[int, int, int]] = {}
    with BamReader(path) as r:
        for read in r:
            tags = read.tags
            if "HP" in tags and "PC" in tags and "PS" in tags:
                out[read.name] = (int(tags["HP"]), int(tags["PS"]), int(tags["PC"]))
    return out


def read_hap_tables_from_dir(snp_phasing_dir: str,
                             chrom_names: list[str]) -> dict[str, dict]:
    """Per-chromosome read→haplotype maps from a snp_phasing/ directory.

    Accepts either the framework's .haplotags.tsv tables or reference-style
    haplotagged {chr}.bam / chr{chr}.bam files (reference looks for both
    spellings, sv_phasing_fn.py:19-24)."""
    from duet_tpu_torch.pipeline import read_haplotag_table

    out: dict[str, dict] = {}
    for name in chrom_names:
        bare = name.removeprefix("chr")
        found = False
        for stem in (name, "chr" + bare, bare):
            tsv = os.path.join(snp_phasing_dir, f"{stem}.haplotags.tsv")
            if os.path.exists(tsv):
                out[name] = read_haplotag_table(tsv)
                found = True
                break
        if found:
            continue
        for stem in (name, "chr" + bare, bare):
            p = os.path.join(snp_phasing_dir, f"{stem}.bam")
            if os.path.exists(p):
                out[name] = read_hap_from_bam(p)
                break
    return out
