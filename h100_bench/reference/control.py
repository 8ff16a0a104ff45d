"""The control: the reference put in the program's place and computed in
the precision below the one the configuration states.

The program computes in float32 on the card with TF32 switched off
(``duet_tpu_torch.device.resolve``).  The step below it that a later change
could take is TF32 for the neural caller's matrix products, and bfloat16
for the phasing's sums: those are scatter-adds, which TF32 does not touch.
A run of the control must come out as not correct; its readings set the
upper end of each limit (PERF.md).
"""

from __future__ import annotations

import numpy as np

from h100_bench.reference.stages import Precision


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    to even), as the tensor cores take a float32 product's inputs when TF32
    is allowed."""
    x = np.ascontiguousarray(x, np.float32)
    b = x.view(np.uint32)
    lsb = (b >> np.uint32(13)) & np.uint32(1)
    r = ((b + np.uint32(0x0FFF) + lsb) & np.uint32(0xFFFFE000)).view(
        np.float32)
    return np.where(np.isfinite(x), r, x)


def matmul_tf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """A matrix product of TF32-rounded inputs, accumulated in float32."""
    return tf32(a) @ tf32(b)


def scatter_sum_bf16(n: int, idx: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """(n,) sums of `vals` by `idx`, each term and each partial sum held in
    bfloat16."""
    import torch

    out = torch.zeros(n, dtype=torch.bfloat16)
    out.index_add_(0, torch.from_numpy(np.asarray(idx, np.int64)),
                   torch.from_numpy(np.asarray(vals, np.float32)).to(
                       torch.bfloat16))
    return out.to(torch.float64).numpy()


CONTROL = Precision("tf32-bf16", matmul=matmul_tf32,
                    scatter_sum=scatter_sum_bf16)
