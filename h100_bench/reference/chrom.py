# A frozen copy of duet_tpu_torch/utils/chrom.py for the benchmark's plain
# reference: imports point into h100_bench.reference; the native and
# device routes, and what the reference never calls, are taken out.
"""Chromosome / contig naming semantics.

The reference pipeline restricts work to human chr1-22, X, Y unless
``--include_all_ctgs`` is passed, and accepts both ``chrN`` and ``N``
spellings everywhere (reference: src/duet/read_file.py:6-16 and the
``s[0] in ['chr'+c, c]`` membership tests throughout sv_phasing_fn.py).
"""

from __future__ import annotations

from typing import Iterable


def standard_chrom_names() -> list[str]:
    """The 24 canonical human chromosome labels, without 'chr' prefix.

    Mirrors reference src/duet/read_file.py:6-12 ('1'..'22', 'X', 'Y').
    """
    return [str(i) for i in range(1, 23)] + ["X", "Y"]


def matches_chrom(contig: str, name: str) -> bool:
    """True if a VCF/BAM contig label refers to canonical chromosome `name`."""
    return contig == name or contig == "chr" + name


def strip_chr(contig: str) -> str:
    return contig[3:] if contig.startswith("chr") else contig


def resolve_contig_names(
    available: Iterable[str], include_all_ctgs: bool
) -> list[str]:
    """Work list of canonical names given the contigs present in the input.

    With include_all_ctgs, every available contig is processed in input order
    (reference: read_file.py:13-15 lists contigs from the pileup VCF).
    Otherwise the fixed 24-chromosome list is used regardless of presence
    (reference: read_file.py:7-12 — absent chromosomes simply yield no calls).
    """
    if include_all_ctgs:
        seen: list[str] = []
        for c in available:
            if c not in seen:
                seen.append(c)
        return seen
    return standard_chrom_names()

