"""The plain reference of one sample: BAM + FASTA -> the four stages'
artifacts, on the host route in numpy.

It follows ``duet_tpu_torch.pipeline.run_pipeline`` for one process with
the stages on the host (``--device-stages off``): the Python BAM reader,
the numpy pileup, the counting rule or the neural caller, SV calling,
phasing and the SV decision tree.  It imports nothing of the program and
reads only the BAM and FASTA the program was handed.  The artifacts are
written as plain text under the same relative paths (``.vcf`` where the
program writes ``.vcf.gz``).

``follow`` hands the phasing stages of a contig that the neural caller
called the SNP calls read from the program's ``pileup.vcf.gz`` in place of
the reference's own.  The comparison judges those calls first, by the
logit gap (``compare.snp_diff``); a neural call that differs from the
reference's only where two logits nearly tie then does not carry into the
later layers' comparison.  There the phasing check covers the program's
own calls.  Under the counting rule, integer arithmetic with one right
answer, the reference phases its own calls and takes nothing from the
program.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from h100_bench.reference.chrom import resolve_contig_names, strip_chr
from h100_bench.reference.fasta import FastaFile
from h100_bench.reference.readstore import load_read_store
from h100_bench.reference.snp_caller_host import (
    ContigSnps,
    SnpCallConfig,
    pileup_with_counts,
    read_pileup_vcf,
    write_pileup_vcf,
)
from h100_bench.reference.snp_phaser_host import (
    read_hap_map,
    support_read_intervals,
    write_phased_snp_vcf,
)
from h100_bench.reference.stages import (
    FLOAT32,
    Precision,
    call_contig_with_evidence,
    call_snps_any,
    phase_callset,
    phase_contig,
)
from h100_bench.reference.sv_caller_host import (
    SvCallConfig,
    call_bnds,
    write_sv_vcf,
)
from h100_bench.reference.vcf import (
    append_phased_sv_records,
    parse_sv_vcf,
    write_phased_sv_header,
)


@dataclass
class RunFlags:
    """The pipeline's flags that change what it computes, with the CLI's
    defaults (``PipelineConfig``); the routing flags change nothing."""

    snp_model: str = "auto"
    min_allele_frequency: float = 0.25
    cluster_max_distance: float = 0.9
    sv_min_size: int = 50
    min_support_read: int = 2
    sv_caller: str = "cutesv"
    min_junction_evidence: float = 0.0
    adaptive_junction_split: bool = True

    def snp_cfg(self) -> SnpCallConfig:
        return SnpCallConfig(min_af=self.min_allele_frequency,
                             model=self.snp_model)

    def sv_cfg(self) -> SvCallConfig:
        return SvCallConfig(
            linkage="span" if self.sv_caller == "svim" else "gap",
            cluster_max_distance=self.cluster_max_distance,
            min_size=self.sv_min_size,
            min_support=self.min_support_read)


@dataclass
class Reference:
    """What a run of the reference leaves: its output directory and the
    neural caller's candidates by contig (empty under the counting rule)."""

    out_dir: str
    nn: dict


def _no_snps(contig: str) -> ContigSnps:
    z = np.zeros(0, np.int64)
    return ContigSnps(contig, z, z.astype(np.uint8), z.astype(np.uint8),
                      z.astype(bool), z.astype(np.int32), z.astype(np.int32))


def _at_sites(obs, site_pos: np.ndarray, length: int):
    """The observations at `site_pos`: ``filter_observations_to_sites``
    with a position mask in place of its search (the same rows in the
    same order)."""
    positions = obs[0]
    mask = np.zeros(length + 1, dtype=bool)
    mask[site_pos] = True
    at = mask[np.minimum(positions, length)]
    return tuple(a[at] for a in obs)


def _work_contigs(available: list[str]) -> list[str]:
    """Contigs to process (chr1-22, X, Y), accepting chrN/N spellings."""
    out = []
    for name in resolve_contig_names(available, False):
        for c in available:
            if c == name or c == "chr" + name or strip_chr(c) == name:
                out.append(c)
                break
    return out


def _protect_intervals(flags: RunFlags, cr, calls):
    """Support-read spans of the contig's SV calls that reach the decision
    stage: weak-junction splitting may not cut a phase set inside them."""
    if not calls or cr is None:
        return None
    names: set[str] = set()
    for c in calls:
        length = abs(getattr(c, "length", None) or getattr(c, "svlen", 0))
        if length >= flags.sv_min_size and \
                c.support >= flags.min_support_read and c.gt != "./.":
            names.update(c.read_names)
    if not names:
        return None
    return support_read_intervals(cr, names)


def run_reference(bam: str, fasta: str, out_dir: str, flags: RunFlags,
                  prec: Precision = FLOAT32,
                  follow: str | None = None) -> Reference:
    """Write the reference's artifacts for one sample under `out_dir`.
    `follow`: the program's pileup.vcf.gz, whose calls the phasing stages
    take where the neural caller called (see the module's docstring)."""
    for sub in ("snp_calling", "sv_calling", "snp_phasing"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    ref = FastaFile(fasta)
    store = load_read_store(bam)
    followed = read_pileup_vcf(follow) if follow is not None else None

    work_fa = _work_contigs(ref.contig_names)
    ref_codes = {}
    for store_name in store.contigs:
        for fa_name in work_fa:
            if strip_chr(store_name) == strip_chr(fa_name):
                ref_codes[store_name] = ref.fetch_codes(fa_name)
                break
    snp_cfg = flags.snp_cfg()

    def snp_stage(contig):
        codes = ref_codes[contig]
        obs, counts = pileup_with_counts(store.contigs[contig], snp_cfg,
                                         len(codes))
        snps, cand = call_snps_any(contig, counts, codes, snp_cfg, prec)
        phasing = snps if followed is None or cand is None \
            else followed.get(contig, _no_snps(contig))
        return snps, cand, phasing, _at_sites(obs, phasing.pos, len(codes))

    work = [c for c in store.contigs if c in ref_codes]
    with ThreadPoolExecutor(max(len(work), 1)) as ex:
        done = dict(zip(work, ex.map(snp_stage, work)))
    snps = {c: d[0] for c, d in done.items()}
    nn = {c: d[1] for c, d in done.items() if d[1] is not None}
    phasing_snps = {c: d[2] for c, d in done.items()}
    site_obs = {c: d[3] for c, d in done.items()}
    del done
    write_pileup_vcf(os.path.join(out_dir, "snp_calling", "pileup.vcf"),
                     snps, store.contig_lengths)

    sv_cfg = flags.sv_cfg()
    calls, evidence = {}, {}
    for contig, cr in store.contigs.items():
        calls[contig], evidence[contig] = call_contig_with_evidence(cr, sv_cfg)
    variants = os.path.join(out_dir, "sv_calling", "variants.vcf")
    write_sv_vcf(variants, calls, store.contig_lengths,
                 family=flags.sv_caller, bnds=call_bnds(evidence, sv_cfg))

    read_haps = {}
    for contig, s in phasing_snps.items():
        cr = store.contigs[contig]
        result = phase_contig(
            cr, s, snp_cfg, site_obs[contig], prec,
            min_junction_evidence=flags.min_junction_evidence,
            adaptive_junction_split=flags.adaptive_junction_split,
            protect_intervals=_protect_intervals(flags, cr,
                                                 calls.get(contig)))
        read_haps[contig] = read_hap_map(cr, result)
        ph = os.path.join(out_dir, "snp_phasing")
        write_phased_snp_vcf(os.path.join(ph, f"phased_{contig}.vcf"),
                             contig, s, result)
        with open(os.path.join(ph, f"{contig}.haplotags.tsv"), "w") as f:
            for name, (hap, ps, pc) in read_haps[contig].items():
                f.write(f"{name}\t{hap}\t{ps}\t{pc}\n")

    per_chrom = parse_sv_vcf(variants, False)
    by_name = {}
    for name in per_chrom:
        for contig, m in read_haps.items():
            if contig == name or strip_chr(contig) == strip_chr(name):
                by_name[name] = m
                break
    phased = phase_callset(per_chrom, by_name, flags.sv_min_size,
                           flags.min_support_read)
    artifact = os.path.join(out_dir, "phased_sv.vcf")
    write_phased_sv_header(variants, artifact, False)
    append_phased_sv_records(phased, artifact)
    return Reference(out_dir, nn)

