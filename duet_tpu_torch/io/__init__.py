from duet_tpu_torch.io.bgzf import BgzfReader, BgzfWriter, is_bgzf
from duet_tpu_torch.io.fasta import FastaFile, write_fasta, write_fai
from duet_tpu_torch.io.bam import (
    BamHeader,
    BamRead,
    BamReader,
    BamWriter,
    write_bam_index,
)
from duet_tpu_torch.io.vcf import (
    SVRecord,
    list_chroms,
    open_maybe_gzip,
    parse_sv_vcf,
    read_vcf_lines,
)
from duet_tpu_torch.io.bai import bam_query, write_bai
from duet_tpu_torch.io.readstore import (
    ContigReads,
    ReadStore,
    load_read_store,
    stream_contig_reads,
    stream_contig_reads_auto,
)
from duet_tpu_torch.io.tabix import query as tabix_query, write_tabix_index
