"""Dense K1 haplotag scoring in plain torch: the twins of
``duet_tpu.ops.haplotag.phase_and_tag`` and ``phase_and_tag_batch``, and
the plain versions of the Pallas kernels of
``duet_tpu.ops.pallas_haplotag`` (``power_sweep_votes`` for
``_sweep_kernel``, ``haplotag_score_plain`` for ``_kernel``).

Reads and phased het sites of a window form a dense (R x S) signed allele
matrix (+1 alt, -1 ref, 0 not covered), quality-weighted.  Scoring is three
products against rhs = [phase | informative | block one-hot]:

  signed = (A*W) @ phase    -> hap = sign, PC from |signed|
  total  = |A*W| @ informative
  blockw = |A*W| @ onehot   -> best block = first argmax

As in the JAX package, aw is formed in bfloat16 (allele x weight, both
exact for quality weights <= 40) and every product is summed in float32:
torch's bf16 @ bf16 returns bf16, which would round sums above 256, so the
operands are widened to float32 first.  All sums are integers below 2^24,
hence exact in any summation order.  The hand kernels
(``ops.haplotag_kernel``) are pinned bit-equal to these functions.
"""

from __future__ import annotations

import torch

PC_PER_MARGIN = 10
PC_MAX = 8100


def _aw(alleles: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """bf16 product allele x weight, widened to float32."""
    return (alleles.to(torch.bfloat16) * weights.to(torch.bfloat16)).float()


def _epilogue(signed, total, blockw):
    """(hap, pc, best) int32 from the three products."""
    tagged = (total > 0) & (signed != 0)
    hap = torch.where(tagged, torch.where(signed > 0, 1, 2), 0).to(torch.int32)
    pc = torch.clamp(torch.round(PC_PER_MARGIN * signed.abs()), 1, PC_MAX)
    pc = torch.where(tagged, pc.to(torch.int32), -1).to(torch.int32)
    best = torch.argmax(blockw, dim=-1).to(torch.int32)  # first max wins
    return hap, pc, best


def power_sweep_votes(alleles: torch.Tensor, weights16: torch.Tensor,
                      phase: torch.Tensor) -> torch.Tensor:
    """One power-iteration sweep over a dense window: the plain version of
    the Pallas ``_sweep_kernel``.

    alleles (R, S) int8; weights16 (R, S), taken as bf16; phase (S,)
    +1/-1/0.  Returns the (S,) float32 site votes ``aw.T @ sign(aw @
    phase)``.  The float32 sums are exact while 40 * R < 2^24 (and
    40 * S < 2^24), i.e. below 419,430 rows."""
    aw = _aw(alleles, weights16)
    h = torch.sign(aw @ phase.float())
    return aw.T @ h


def haplotag_score_plain(aw: torch.Tensor, abs_aw: torch.Tensor,
                         rhs: torch.Tensor, n_blocks: int):
    """Read scoring on a precomputed aw and |aw|: the plain version of the
    Pallas ``_kernel``.

    aw, abs_aw (R, S) bf16; rhs (S, K) [phase | informative | block
    one-hot], taken as bf16.  Returns (hap, pc, best_block), each (R,)
    int32."""
    rhs32 = rhs.to(torch.bfloat16).float()
    signed = aw.float() @ rhs32[:, 0]
    rest = abs_aw.float() @ rhs32[:, 1:]
    return _epilogue(signed, rest[:, 0], rest[:, 1:1 + n_blocks])


def phase_and_tag_batch(alleles: torch.Tensor, weights: torch.Tensor,
                        rhs: torch.Tensor, n_tasks: int, n_blocks: int):
    """`n_tasks` stacked scoring chunks in one call.

    alleles (n_tasks*R, S) int8; weights the same shape (any float, taken
    as bf16); rhs (n_tasks*S, K) — per-task [phase | informative |
    block-onehot] stacked on the site axis.  Returns (hap, pc, best_block),
    each (n_tasks*R,) int32."""
    R = alleles.shape[0] // n_tasks
    S = alleles.shape[1]
    aw = _aw(alleles, weights).reshape(n_tasks, R, S)
    rhs3 = rhs.to(torch.bfloat16).float().reshape(n_tasks, S, -1)
    signed = torch.bmm(aw, rhs3[:, :, :1])[..., 0]
    rest = torch.bmm(aw.abs(), rhs3[:, :, 1:])
    hap, pc, best = _epilogue(signed, rest[..., 0], rest[..., 1:1 + n_blocks])
    return hap.reshape(-1), pc.reshape(-1), best.reshape(-1)


def phase_and_tag(alleles: torch.Tensor, weights: torch.Tensor,
                  phase0: torch.Tensor, block_onehot: torch.Tensor,
                  sweeps: int = 2) -> dict[str, torch.Tensor]:
    """Phasing power iteration (`sweeps` >= 0 rounds) + read scoring over
    one dense window.

    alleles (R, S) int8; weights (R, S) float; phase0 (S,) +1/-1/0;
    block_onehot (S, B).  Returns the dict of the JAX function: hap, pc,
    best_block, signed, total (float32) and the refined int8 phase."""
    aw = _aw(alleles, weights)
    covered = phase0 != 0
    phase = phase0.to(torch.bfloat16).float()
    for _ in range(sweeps):
        h = torch.sign(aw @ phase)
        votes = aw.T @ h
        new_phase = torch.where(votes > 0, 1.0,
                                torch.where(votes < 0, -1.0, phase))
        phase = torch.where(covered, new_phase, 0.0)
    informative = (phase != 0).float()
    signed = aw @ phase
    total = aw.abs() @ informative
    blockw = aw.abs() @ block_onehot.to(torch.bfloat16).float()
    hap, pc, best = _epilogue(signed, total, blockw)
    return {"hap": hap, "pc": pc, "best_block": best, "signed": signed,
            "total": total, "phase": torch.sign(phase).to(torch.int8)}
