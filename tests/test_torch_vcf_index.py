"""The .vcf.gz writer that indexes from its BGZF writer's offsets
(``io.vcf.write_vcf_indexed``, ``io.tabix.tabix_payload``) against the
writer that re-reads the file it wrote (``io.vcf.write_vcf``,
``io.tabix.build_tabix_index``): the same .vcf.gz and .tbi bytes, on one
thread and on four.  Then the columnar SNP writers
(``models.snp_caller.write_pileup_vcf``,
``models.snp_phaser.write_phased_snp_vcf``) against the host copies'
(``models.*_host``), file and index byte for byte, and the counters that
say which way each index was built."""

import numpy as np
import pytest

from duet_tpu_torch.io.bgzf import _MAX_BLOCK
from duet_tpu_torch.io.tabix import build_tabix_index, query
from duet_tpu_torch.io.vcf import write_vcf, write_vcf_indexed
from duet_tpu_torch.models import snp_caller, snp_caller_host
from duet_tpu_torch.models import snp_phaser, snp_phaser_host
from duet_tpu_torch.models.snp_caller_host import ContigSnps
from duet_tpu_torch.models.snp_phaser_host import PhaseResult
from duet_tpu_torch.utils import spans

HEADER = ["##fileformat=VCFv4.2",
          "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"]
SITE = "\t.\t{ref}\tT\t30\tPASS\t{info}\tGT\t0/1"


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


class _Lines:
    """Records, their reference ids and intervals, built in file order."""

    def __init__(self, names, header=HEADER):
        self.names, self.header = names, header
        self.records, self.rid, self.beg, self.end = [], [], [], []

    def size(self) -> int:
        """Uncompressed bytes of the file so far."""
        return sum(len(s) + 1 for s in self.header + self.records)

    def add(self, rid, pos, ref="A", info=".", end=None):
        """A record at 1-based `pos`; with `end`, an SV whose INFO END=
        is it."""
        if end is not None:
            info = f"SVTYPE=DEL;END={end}"
        self.records.append(f"{self.names[rid]}\t{pos}"
                            + SITE.format(ref=ref, info=info))
        self.rid.append(rid)
        self.beg.append(pos - 1)
        self.end.append(max(pos - 1 + len(ref), end or 0))

    def fill_to(self, rid, pos, at):
        """Records from `pos` on, one a 100 bp, the last padded so that
        its newline is the byte before uncompressed offset `at`."""
        while at - self.size() > 300:
            self.add(rid, pos)
            pos += 100
        bare = self.size() + len(f"{self.names[rid]}\t{pos}"
                                 + SITE.format(ref="A", info="")) + 1
        self.add(rid, pos, info="X" * (at - bare))
        assert self.size() == at
        return pos + 100


def _no_records():
    return _Lines(["chr1"])


def _one_record():
    lines = _Lines(["chr1"])
    lines.add(0, 1234)
    return lines


def _no_header():
    """The first record starts at virtual offset 0, which the linear
    index reads as no record: the window takes the next record's."""
    lines = _Lines(["chr1"], header=[])
    for pos in (10, 20, 30):
        lines.add(0, pos)
    return lines


def _straddles_a_block():
    lines = _Lines(["chr1"])
    pos = lines.fill_to(0, 100, _MAX_BLOCK - 40)
    lines.add(0, pos, info="Y" * 120)      # from 40 before the edge to 81 past
    lines.add(0, pos + 100)
    return lines


def _ends_on_a_block():
    lines = _Lines(["chr1"])
    pos = lines.fill_to(0, 100, _MAX_BLOCK)
    lines.add(0, pos)                      # the next block's first byte
    pos = lines.fill_to(0, pos + 100, 2 * _MAX_BLOCK)
    return lines


def _several_contigs():
    """Three contigs, the later two starting past empty 16 kb windows,
    which stay empty rather than take the contig before's offsets."""
    lines = _Lines(["chr1", "chr2", "chrX"])
    for rid, n in ((0, 700), (2, 1), (1, 900)):
        for k in range(n):
            lines.add(rid, 5 + 37 * k + 50_000 * rid)
    return lines


def _sv_records():
    """SVs whose END= spans several 16 kb windows and bins of every level,
    among SNVs in the bins they cover, and a REF longer than one base."""
    lines = _Lines(["chr1", "chr2"])
    lines.add(0, 10)
    lines.add(0, 100, end=50_000)          # 4 windows, a 128 kb bin
    lines.add(0, 16_000, ref="ACGTACGTAC")
    lines.add(0, 16_390, ref="ACGTACGTAC")  # crosses a window edge
    lines.add(0, 20_000, end=1_200_000)    # a 8 Mb bin, 73 windows
    lines.add(0, 40_000)
    lines.add(0, 130_000, end=9_000_000)   # a 64 Mb bin
    lines.add(0, 131_000)
    lines.add(0, 200_000, end=70_000_000)  # bin 0
    lines.add(0, 300_000, end=300_001)
    lines.add(1, 1, end=20_000)
    lines.add(1, 17_000)
    return lines


def _carries_at_the_end():
    """The last record starts near a block's end, so its start plus its
    length carries past the virtual offset's 16 bits into its block
    part."""
    lines = _Lines(["chr1"])
    pos = lines.fill_to(0, 100, _MAX_BLOCK - 30)
    lines.add(0, pos, info="Z" * 400)
    return lines


def _many_blocks():
    """About 30 blocks: the threaded writer has blocks in flight."""
    rng = np.random.default_rng(11)
    lines = _Lines(["chr1", "chr2"])
    for rid in (0, 1):
        pos = np.cumsum(rng.integers(1, 400, 12_000)) + 1
        for p in pos.tolist():
            lines.add(rid, p, info=f"DP={p % 97}")
    return lines


INDEX_CASES = {
    "no_records": _no_records,
    "one_record": _one_record,
    "no_header": _no_header,
    "straddles_a_block": _straddles_a_block,
    "ends_on_a_block": _ends_on_a_block,
    "several_contigs": _several_contigs,
    "sv_records": _sv_records,
    "carries_at_the_end": _carries_at_the_end,
    "many_blocks": _many_blocks,
}


@pytest.mark.parametrize("case", list(INDEX_CASES))
def test_index_from_offsets_is_the_reread_index(tmp_path, case):
    lines = INDEX_CASES[case]()
    want = str(tmp_path / "reread.vcf.gz")
    write_vcf(want, lines.header, lines.records)
    for threads in (1, 4):
        got = str(tmp_path / f"t{threads}.vcf.gz")
        write_vcf_indexed(got, lines.header, lines.records, lines.names,
                          lines.rid, lines.beg, lines.end, threads=threads)
        assert _bytes(got) == _bytes(want), threads
        assert _bytes(got + ".tbi") == _bytes(want + ".tbi"), threads
    assert build_tabix_index(got) == build_tabix_index(want)
    if lines.records:
        # the index reaches the last record
        last = lines.records[-1].split("\t")
        hits = query(got, last[0], lines.beg[-1], lines.end[-1])
        assert lines.records[-1] in hits


def _snps(contig, pos, het, rng):
    n = len(pos)
    depth = rng.integers(8, 60, n).astype(np.int32)
    return ContigSnps(contig, np.asarray(pos, np.int64),
                      rng.integers(0, 4, n).astype(np.uint8),
                      rng.integers(0, 4, n).astype(np.uint8),
                      np.asarray(het, bool), depth,
                      (depth // rng.integers(1, 4, n)).astype(np.int32))


def _phase(snps, rng, unphased=0.2, n_blocks=3):
    """A PhaseResult over the het sites in position order: phases +-1 or
    0, the phased sites cut into `n_blocks` blocks."""
    het = np.flatnonzero(snps.is_het)
    site_pos = np.sort(snps.pos[het])
    m = len(site_pos)
    phase = rng.choice(np.array([1, -1], np.int8), m)
    phase[rng.random(m) < unphased] = 0
    block_id = np.minimum(np.arange(m) * n_blocks // max(m, 1),
                          n_blocks - 1).astype(np.int32)
    block_id[phase == 0] = -1
    block_ps = np.array([int(site_pos[block_id == b].min()) + 1
                         if (block_id == b).any() else 1
                         for b in range(n_blocks)], np.int64)
    return PhaseResult(site_pos, phase, block_id, block_ps,
                       np.zeros(0, np.int8), np.zeros(0, np.int64),
                       np.zeros(0, np.int32))


def _contig(contig, n, rng, het_share=0.7):
    pos = np.sort(rng.choice(2_000_000, n, replace=False))
    return _snps(contig, pos, rng.random(n) < het_share, rng)


def _het_and_hom(rng):
    s = _contig("chr1", 3000, rng)
    return {"chr1": s}, {"chr1": _phase(s, rng, unphased=0.0, n_blocks=1)}


def _unphased(rng):
    s = _contig("chr1", 500, rng)
    return {"chr1": s}, {"chr1": _phase(s, rng, unphased=1.0, n_blocks=1)}


def _blocks(rng):
    snps = {c: _contig(c, 2000, rng) for c in ("chr1", "chr2")}
    return snps, {c: _phase(s, rng, n_blocks=7) for c, s in snps.items()}


def _empty_contig(rng):
    snps = {"chr1": _contig("chr1", 800, rng),
            "chr2": _snps("chr2", [], [], rng),
            "chr3": _contig("chr3", 300, rng)}
    return snps, {c: _phase(s, rng) for c, s in snps.items()}


def _not_increasing(rng):
    """Positions out of order and a het position twice: the last het row
    of a position wins, as in the host copy's map of position to row."""
    pos = rng.permutation(rng.choice(500_000, 600, replace=False))
    het = rng.random(600) < 0.6
    het[:2] = True
    pos[1] = pos[0]
    s = _snps("chr1", pos, het, rng)
    return {"chr1": s}, {"chr1": _phase(s, rng, n_blocks=4)}


WRITER_CASES = {
    "het_and_hom": _het_and_hom,
    "unphased": _unphased,
    "blocks": _blocks,
    "empty_contig": _empty_contig,
    "not_increasing": _not_increasing,
}


@pytest.mark.parametrize("case", list(WRITER_CASES))
def test_columnar_writers_are_the_host_writers(tmp_path, case):
    snps, results = WRITER_CASES[case](np.random.default_rng(len(case)))
    lengths = {c: 2_000_000 for c in snps}
    host, cols = tmp_path / "host", tmp_path / "cols"
    host.mkdir()
    cols.mkdir()
    snp_caller_host.write_pileup_vcf(str(host / "pileup.vcf.gz"), snps,
                                     lengths)
    for c, s in snps.items():
        snp_phaser_host.write_phased_snp_vcf(
            str(host / f"phased_{c}.vcf.gz"), c, s, results[c])
    spans.reset("index.tabix.")
    snp_caller.write_pileup_vcf(str(cols / "pileup.vcf.gz"), snps, lengths,
                                threads=4)
    for c, s in snps.items():
        snp_phaser.write_phased_snp_vcf(str(cols / f"phased_{c}.vcf.gz"), c,
                                        s, results[c], threads=2)
    counters = spans.snapshot("index.tabix.")["counters"]
    spans.reset("index.tabix.")
    assert counters == {"index.tabix.from_writer": 1 + len(snps)}
    for name in ["pileup.vcf.gz"] + [f"phased_{c}.vcf.gz" for c in snps]:
        for ext in ("", ".tbi"):
            assert _bytes(cols / (name + ext)) == _bytes(host / (name + ext)), \
                name + ext


def test_phased_writer_raises_on_a_site_with_no_het_row(tmp_path):
    """A phased site that no het row holds raises KeyError, as the host
    copy's map does."""
    rng = np.random.default_rng(3)
    s = _contig("chr1", 100, rng)
    result = _phase(s, rng)
    result.site_pos = result.site_pos + 1
    for writer in (snp_phaser_host.write_phased_snp_vcf,
                   snp_phaser.write_phased_snp_vcf):
        with pytest.raises(KeyError):
            writer(str(tmp_path / "x.vcf.gz"), "chr1", s, result)
