"""Chromosome / contig naming semantics.

The reference pipeline restricts work to human chr1-22, X, Y unless
``--include_all_ctgs`` is passed, and accepts both ``chrN`` and ``N``
spellings everywhere (reference: src/duet/read_file.py:6-16 and the
``s[0] in ['chr'+c, c]`` membership tests throughout sv_phasing_fn.py).
"""

from __future__ import annotations

from typing import Iterable, Sequence


def standard_chrom_names() -> list[str]:
    """The 24 canonical human chromosome labels, without 'chr' prefix.

    Mirrors reference src/duet/read_file.py:6-12 ('1'..'22', 'X', 'Y').
    """
    return [str(i) for i in range(1, 23)] + ["X", "Y"]


def chrom_aliases(name: str) -> tuple[str, str]:
    """Both accepted spellings for a canonical name ('21' -> ('chr21', '21'))."""
    return ("chr" + name, name)


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


def lexicographic_sort_key(contig: str, pos: int):
    """Output ordering of the final callset: lexicographic on the contig
    string, numeric on position (reference: sv_phasing_fn.py:229 sorts with
    itemgetter('chrom','pos') on the raw chrom string, so 'chr10' < 'chr2')."""
    return (contig, pos)


def order_contigs_like_reference(contigs: Sequence[str]) -> list[str]:
    """Stable canonical iteration order 1..22,X,Y used by the per-chromosome
    loops (reference: sv_phasing_fn.py:17,41,197,206)."""
    std = standard_chrom_names()
    order = {n: i for i, n in enumerate(std)}
    return sorted(contigs, key=lambda c: order.get(strip_chr(c), 10_000))
