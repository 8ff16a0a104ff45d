"""Batched haplotag scoring: the CUDA kernel ``csrc/haplotag_score.cu`` and
its wrapper, the port of ``duet_tpu.ops.pallas_haplotag``'s
``haplotag_score_batch_pallas`` (the Pallas ``_score_kernel``).

``haplotag_score_batch`` takes the pipeline's dense chunks — int8 alleles,
bf16 weights and the per-task bf16 rhs — and returns (hap, pc, best) as
three int32 vectors.  On a CUDA tensor it launches the kernel (built by nvcc
at first use) or raises; on a CPU tensor it runs the plain torch version,
``ops.haplotag.phase_and_tag_batch``, which the kernel is pinned bit-equal
to.  ``LAUNCHES`` counts kernel launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from duet_tpu_torch.ops.haplotag import phase_and_tag_batch

MAX_K = 128          # rhs columns the kernel holds: [phase | informative | blocks]
LAUNCHES = 0         # kernel launches since import (or since a caller reset it)
_lock = threading.Lock()


@functools.cache
def _library() -> ctypes.CDLL:
    from duet_tpu_torch.ops.cuda_build import load

    lib = load("haplotag_score", ["haplotag_score.cu"])
    lib.duet_haplotag_score.argtypes = [ctypes.c_void_p] * 6 + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.duet_haplotag_score.restype = ctypes.c_int
    lib.duet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.duet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(alleles, weights16, rhs, n_tasks: int, n_blocks: int) -> None:
    if not (alleles.device == weights16.device == rhs.device):
        raise ValueError("alleles, weights16 and rhs must share one device")
    if alleles.dtype != torch.int8 or alleles.dim() != 2:
        raise TypeError("alleles must be a 2-D int8 tensor")
    if weights16.dtype != torch.bfloat16 or weights16.shape != alleles.shape:
        raise TypeError("weights16 must be bfloat16 with the alleles' shape")
    if rhs.dtype != torch.bfloat16 or rhs.dim() != 2:
        raise TypeError("rhs must be a 2-D bfloat16 tensor")
    if n_tasks < 1 or alleles.shape[0] % n_tasks:
        raise ValueError(f"{alleles.shape[0]} rows do not split into "
                         f"{n_tasks} tasks")
    S, K = alleles.shape[1], rhs.shape[1]
    if rhs.shape[0] != n_tasks * S:
        raise ValueError(f"rhs has {rhs.shape[0]} rows, want n_tasks*S = "
                         f"{n_tasks * S}")
    if not 3 <= K <= MAX_K or not 1 <= n_blocks <= K - 2:
        raise ValueError(f"need 3 <= K <= {MAX_K} and 1 <= n_blocks <= K-2, "
                         f"got K={K}, n_blocks={n_blocks}")
    if not (alleles.is_contiguous() and weights16.is_contiguous()
            and rhs.is_contiguous()):
        raise ValueError("alleles, weights16 and rhs must be contiguous")


def haplotag_score_batch(alleles: torch.Tensor, weights16: torch.Tensor,
                         rhs: torch.Tensor, n_tasks: int, n_blocks: int):
    """Score `n_tasks` stacked (R, S) chunks in one launch.

    alleles   (n_tasks*R, S) int8
    weights16 (n_tasks*R, S) bfloat16
    rhs       (n_tasks*S, K) bfloat16, K <= 128: per-task [phase |
              informative | block one-hot] stacked on the site axis
    Returns (hap, pc, best), each (n_tasks*R,) int32."""
    global LAUNCHES
    _check(alleles, weights16, rhs, n_tasks, n_blocks)
    dev = alleles.device
    if dev.type == "cpu":
        return phase_and_tag_batch(alleles, weights16, rhs, n_tasks, n_blocks)
    if dev.type != "cuda":
        raise ValueError(f"no haplotag kernel for device {dev}")
    lib = _library()
    rows = alleles.shape[0]
    hap, pc, best = (torch.empty(rows, dtype=torch.int32, device=dev)
                     for _ in range(3))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.duet_haplotag_score(
            alleles.data_ptr(), weights16.data_ptr(), rhs.data_ptr(),
            hap.data_ptr(), pc.data_ptr(), best.data_ptr(), n_tasks,
            rows // n_tasks, alleles.shape[1], rhs.shape[1], n_blocks, stream)
    if rc != 0:
        raise RuntimeError("haplotag_score kernel launch failed: "
                           + lib.duet_cuda_error_string(rc).decode())
    with _lock:
        LAUNCHES += 1
    return hap, pc, best
