"""Phasing power iteration over the COO allele matrix, in torch.

The port of ``duet_tpu.ops.sparse_power._refine`` / ``power_refine_device``:
each sweep is two int32 scatter-adds into (n+1)-bin buffers whose last bin
is the sentinel that padded entries land in,

    per read  s = sum_row allele*weight*phase[col]    -> h = sign(s)
    per site  v = sum_col allele*weight*h[row]        -> phase = sign(v)

with a Python loop in place of ``lax.scan``.  Integer sums have one answer,
so the result is bit-identical to the JAX kernel and the float64 host path.
"""

from __future__ import annotations

import numpy as np
import torch

# launch-size cap of one device refine (copied from duet_tpu.ops.sparse_power,
# whose module imports jax): larger matrices take the host iteration
INT32_EXACT_NNZ = 40_000_000


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
                        sweeps: int = 2,
                        device: torch.device = torch.device("cpu")
                        ) -> np.ndarray:
    """Device twin of ``duet_tpu.models.snp_phaser._power_refine``."""
    from duet_tpu.utils import dispatch
    from duet_tpu_torch.utils import devcost

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
