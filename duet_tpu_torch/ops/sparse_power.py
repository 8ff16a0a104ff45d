"""Phasing power iteration and sparse read scoring over the COO allele
matrix, in torch.

The port of ``duet_tpu.ops.sparse_power``:

- ``_refine`` / ``power_refine_device``: each sweep is two int32
  scatter-adds into (n+1)-bin buffers whose last bin is the sentinel that
  padded entries land in,

      per read  s = sum_row allele*weight*phase[col]    -> h = sign(s)
      per site  v = sum_col allele*weight*h[row]        -> phase = sign(v)

  with a Python loop in place of ``lax.scan``;
- ``_score`` / ``haplotag_score_sparse`` / ``haplotag_score_sparse_multi``:
  the whole-contig read scoring as int32 scatter-adds (signed and total
  per read, block weights per (read, block slot)) and scatter min/max of
  each read's first and last phase-set block.

Integer sums have one answer, so every result is bit-identical to the JAX
functions and the float64 host path.  This is XLA code in the JAX package,
not Pallas, so it stays plain torch on every device.
"""

from __future__ import annotations

import numpy as np
import torch

# launch-size cap of one device refine or scoring batch (copied from
# duet_tpu.ops.sparse_power, whose module imports jax): larger matrices take
# the host path, and multi-contig scoring batches split below it
INT32_EXACT_NNZ = 40_000_000
SLOT_K = 8       # per-read relative block slots (reads spanning more fall back)
PC_PER_MARGIN = 10
PC_MAX = 8100


_CPU = torch.device("cpu")


def _pow2(x: int, floor: int = 8) -> int:
    return max(floor, 1 << (max(x, 1) - 1).bit_length())


def _refine(row, col, av, phase0, covered, sweeps: int, n_reads: int,
            n_sites: int) -> torch.Tensor:
    """row/col padded with the sentinels n_reads / n_sites, av zero there.

    Returns the refined (n_sites,) float32 phase."""
    av32 = av.to(torch.int32)
    row = row.long()
    col = col.long()
    zero = torch.zeros(1, dtype=torch.int32, device=av.device)
    phase = phase0
    for _ in range(sweeps):
        # the sentinel column reads a 0 phase (its av is 0 either way)
        pi = torch.cat([phase.to(torch.int32), zero])
        s = torch.zeros(n_reads + 1, dtype=torch.int32, device=av.device)
        s.index_add_(0, row, av32 * pi[col])
        h = torch.sign(s)
        v = torch.zeros(n_sites + 1, dtype=torch.int32, device=av.device)
        v.index_add_(0, col, av32 * h[row])
        v = v[:n_sites]
        new_phase = torch.where(v > 0, 1.0, torch.where(v < 0, -1.0, phase))
        phase = torch.where(covered, new_phase, 0.0)
    return phase


def power_refine_device(am, phase: np.ndarray, block_id: np.ndarray,
                        sweeps: int = 2, device: torch.device = _CPU
                        ) -> np.ndarray:
    """Device twin of ``duet_tpu.models.snp_phaser._power_refine``."""
    from duet_tpu_torch.utils import devcost, dispatch

    nnz = len(am.row)
    if nnz == 0 or am.n_sites == 0:
        return phase
    dispatch.record("phase_refine", "device")
    n_reads = _pow2(am.n_reads)
    n_sites = _pow2(am.n_sites)
    nnz_pad = _pow2(nnz)
    row = np.full(nnz_pad, n_reads, dtype=np.int32)
    col = np.full(nnz_pad, n_sites, dtype=np.int32)
    av = np.zeros(nnz_pad, dtype=np.float32)
    row[:nnz] = am.row
    col[:nnz] = am.col
    av[:nnz] = am.allele.astype(np.float32) * am.weight
    phase_pad = np.zeros(n_sites, dtype=np.float32)
    phase_pad[:am.n_sites] = phase
    covered = np.zeros(n_sites, dtype=bool)
    covered[:am.n_sites] = block_id >= 0
    dev = devcost.put("phase_refine", device, row, col, av, phase_pad, covered)
    out = devcost.run("phase_refine", device,
                      lambda: _refine(*dev, sweeps, n_reads, n_sites))
    return np.sign(
        devcost.get("phase_refine", out)[:am.n_sites]).astype(np.int8)


def _score(row, col, av, phase, block_id, n_reads: int, n_sites: int):
    """Sparse scoring over one COO (padded; the sentinel row n_reads / col
    n_sites index the junk bins).  phase and block_id are (n_sites+1,)
    int32.  Returns per-read (hap, pc, best_block, overflow) over the
    n_reads + 1 bins.

    Every bin sums one read's (or one (read, slot)'s) integer entries of
    magnitude <= 40, so int32 is exact.  Block ids in col are >= 0
    (``_check_blocks``), so the max-scatter's -1 start marks reads with no
    entries."""
    dev = av.device
    row = row.long()
    col = col.long()
    pv = phase[col]                       # int32 in {-1, 0, +1}
    v = av * pv
    absav = av.abs()
    inf = absav * (pv != 0)
    blk = block_id[col]
    R1 = n_reads + 1                      # + the junk bin (sentinel rows)

    def bins(fill: int, size: int = R1) -> torch.Tensor:
        return torch.full((size,), fill, dtype=torch.int32, device=dev)

    signed = bins(0).index_add_(0, row, v)
    total = bins(0).index_add_(0, row, inf.to(torch.int32))
    b_lo_raw = bins(1 << 30).scatter_reduce_(0, row, blk, "amin")
    b_hi = bins(-1).scatter_reduce_(0, row, blk, "amax")
    has = b_hi >= 0
    b_lo = torch.where(has, b_lo_raw, 0)
    overflow = has & ((b_hi - b_lo) >= SLOT_K)

    # per-(read, slot) weight sums: one scatter into R1 x SLOT_K bins
    slot = torch.clamp(blk - b_lo[row], 0, SLOT_K - 1)
    key2 = row * SLOT_K + slot
    blockw = bins(0, R1 * SLOT_K).index_add_(0, key2, absav).reshape(
        R1, SLOT_K)
    best_slot = torch.argmax(blockw, dim=1)   # first max = earliest block
    best_block = b_lo + best_slot.to(torch.int32)

    tagged = (total > 0) & (signed != 0)
    hap = torch.where(tagged, torch.where(signed > 0, 1, 2), 0).to(
        torch.int32)
    pc = torch.clamp(PC_PER_MARGIN * signed.abs(), 1, PC_MAX)
    pc = torch.where(tagged, pc, -1).to(torch.int32)
    return hap, pc, best_block, overflow


def warm_up(device: torch.device) -> None:
    """Run ``_refine`` and ``_score`` once on an 8-entry matrix on
    `device`, with the dtypes the pipeline gives them, and wait for them:
    a process's first launch of each torch kernel loads it, and this lets a
    caller pay for that before its first phasing call.  Nothing is recorded
    (no dispatch, no device cost)."""
    from duet_tpu_torch.device import synchronize

    n = 8
    idx = torch.arange(n, dtype=torch.int32, device=device)
    ones = torch.ones(n, dtype=torch.float32, device=device)
    _refine(idx, idx, ones, ones, ones > 0, 2, n, n)
    bins = torch.zeros(n + 1, dtype=torch.int32, device=device)
    _score(idx, idx, idx, bins, bins, n, n)
    synchronize(device)


def _check_blocks(am, block_id: np.ndarray) -> None:
    """The scorer's invariant: every observed site lies in a phase-set
    block (block -1 marks sites with no observations)."""
    if len(am.col) and int(block_id[am.col].min()) < 0:
        raise ValueError("an observed site has phase-set block -1; the "
                         "sparse scorer needs block_id[col] >= 0")


def haplotag_score_sparse_multi(items, device: torch.device = _CPU):
    """ONE device launch scoring several contigs' COO matrices at once.

    `items`: list of (am, phase, block_id) per contig.  The per-contig COO
    blocks concatenate with read/site/block offsets into one matrix: reads
    never straddle contigs and phase-set blocks stay intervals of the
    concatenated site axis, so ``_score`` applies unchanged.

    Returns a list of (hap, pc, best_block, overflow) per item with
    best_block re-based to the item's own block table.  Raises ValueError
    past INT32_EXACT_NNZ (callers split batches below it) and on a block -1
    at an observed site."""
    from duet_tpu_torch.utils import devcost, dispatch

    tot_nnz = sum(len(it[0].row) for it in items)
    if tot_nnz > INT32_EXACT_NNZ:
        raise ValueError(
            f"batched nnz {tot_nnz} exceeds the int32-exactness bound "
            f"{INT32_EXACT_NNZ}; split the batch")
    for am, _, block_id in items:
        _check_blocks(am, block_id)
    tot_reads = sum(it[0].n_reads for it in items)
    tot_sites = sum(it[0].n_sites for it in items)
    n_reads = _pow2(tot_reads)
    n_sites = _pow2(tot_sites)
    nnz_pad = _pow2(max(tot_nnz, 1))
    row = np.full(nnz_pad, n_reads, dtype=np.int32)
    col = np.full(nnz_pad, n_sites, dtype=np.int32)
    av = np.zeros(nnz_pad, dtype=np.int32)
    phase_pad = np.zeros(n_sites + 1, dtype=np.int32)
    blk_pad = np.zeros(n_sites + 1, dtype=np.int32)
    metas = []
    r_off = s_off = b_off = z = 0
    for am, phase, block_id in items:
        k = len(am.row)
        row[z:z + k] = am.row + r_off
        col[z:z + k] = am.col + s_off
        av[z:z + k] = am.allele.astype(np.int32) * am.weight.astype(np.int32)
        phase_pad[s_off:s_off + am.n_sites] = phase
        # block -1 (site with no observations) never appears in col, so the
        # offset shift only needs to be right for covered sites
        blk_pad[s_off:s_off + am.n_sites] = block_id + b_off
        metas.append((r_off, am.n_reads, b_off))
        r_off += am.n_reads
        s_off += am.n_sites
        b_off += int(block_id.max()) + 1 if len(block_id) else 0
        z += k
    dispatch.record("haplotag", "device")
    dev = devcost.put("haplotag", device, row, col, av, phase_pad, blk_pad)
    out = devcost.run("haplotag", device,
                      lambda: _score(*dev, n_reads, n_sites))
    hap, pc, best, ovf = (devcost.get("haplotag", x) for x in out)
    return [
        (hap[r0:r0 + nr].astype(np.int8), pc[r0:r0 + nr],
         best[r0:r0 + nr] - b0, ovf[r0:r0 + nr])
        for r0, nr, b0 in metas
    ]


def haplotag_score_sparse(am, phase: np.ndarray, block_id: np.ndarray,
                          device: torch.device = _CPU):
    """Device twin of ``duet_tpu.models.snp_phaser._haplotag``'s scoring
    math on one contig's COO: ``haplotag_score_sparse_multi`` of the one
    item, which pads it as it would alone.

    Returns (hap, pc, best_block, overflow) numpy arrays of length
    am.n_reads; `overflow` marks reads whose observations span more than
    SLOT_K phase-set blocks — score those on the host.  best_block indexes
    block_ps.  Raises ValueError past INT32_EXACT_NNZ and on a block -1 at
    an observed site."""
    return haplotag_score_sparse_multi([(am, phase, block_id)], device)[0]
