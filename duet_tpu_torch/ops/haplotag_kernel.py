"""Dense haplotag kernels: the CUDA kernels ``csrc/haplotag_score.cu`` and
``csrc/haplotag_sweep.cu`` and their wrappers, the port of
``duet_tpu.ops.pallas_haplotag``.

- ``haplotag_score_batch``: ``haplotag_score_batch_pallas`` (the Pallas
  ``_score_kernel`` with one rhs per task), the pipeline's dense scorer.
- ``phase_and_tag_fused``: ``phase_and_tag_fused`` — ``sweeps`` launches of
  the sweep kernel (``_sweep_kernel``), each followed by the phase update in
  torch, then one score launch with the rhs shared by every row tile.
- ``haplotag_score``: ``haplotag_score_pallas`` (``_kernel``) — aw and |aw|
  formed in torch, then the score kernel's precomputed-aw variant.

On a CUDA tensor each wrapper launches its kernel (built by nvcc at first
use) or raises; on a CPU tensor it runs the kernel's plain torch version
from ``ops.haplotag``, which the kernel is pinned bit-equal to.
``LAUNCHES`` counts the launches of each kernel by name, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from duet_tpu_torch.ops.haplotag import (
    haplotag_score_plain,
    phase_and_tag_batch,
    power_sweep_votes,
)

# kernel launches since import (or since reset_launches), by kernel name:
# the score kernel with per-task rhs (_score_kernel via
# haplotag_score_batch_pallas), the same kernel with one shared rhs
# (phase_and_tag_fused's score launch), its precomputed-aw variant
# (_kernel) and the sweep kernel (_sweep_kernel)
KERNELS = ("haplotag_score", "haplotag_score_shared", "haplotag_score_pre",
           "haplotag_sweep")
LAUNCHES = dict.fromkeys(KERNELS, 0)
_lock = threading.Lock()


def reset_launches() -> None:
    with _lock:
        for k in KERNELS:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


@functools.cache
def _score_library() -> ctypes.CDLL:
    from duet_tpu_torch.ops.cuda_build import load

    lib = load("haplotag_score", ["haplotag_score.cu"])
    for fn in (lib.duet_haplotag_score, lib.duet_haplotag_score_pre):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.duet_haplotag_score_shape.argtypes = [ctypes.c_int] * 4 + \
        [ctypes.POINTER(ctypes.c_int)] * 3
    lib.duet_haplotag_score_shape.restype = ctypes.c_int
    lib.duet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.duet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def score_launch_shape(n_tasks: int, rows_per_task: int, K: int,
                       fused: bool) -> dict[str, int]:
    """The shape the score kernel launches with for these sizes on the
    current CUDA device: warps per CTA, ring stages, dynamic shared memory
    in bytes (for reports; the launch decides the same way)."""
    lib = _score_library()
    warps, stages, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.duet_haplotag_score_shape(n_tasks, rows_per_task, K, int(fused),
                                       warps, stages, smem)
    _raise_on(rc, "haplotag_score_shape", lib.duet_cuda_error_string)
    return {"warps": warps.value, "stages": stages.value,
            "smem_bytes": smem.value}


def sweep_library_name(defines: tuple[str, ...] = ()) -> str:
    """The build name of the sweep library, or of a variant of it."""
    return "_".join(["haplotag_sweep", *(d.replace("=", "")
                                         for d in defines)])


@functools.cache
def _sweep_library(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The sweep kernel's library; `defines` build a variant of its
    one-pass launch shape (see the source note), under its own name."""
    from duet_tpu_torch.ops.cuda_build import load

    lib = load(sweep_library_name(defines), ["haplotag_sweep.cu"], defines)
    lib.duet_haplotag_sweep.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.duet_haplotag_sweep.restype = ctypes.c_int
    lib.duet_haplotag_sweep_shape.argtypes = [ctypes.c_int] * 2 + \
        [ctypes.POINTER(ctypes.c_int)]
    lib.duet_haplotag_sweep_shape.restype = ctypes.c_int
    lib.duet_sweep_error_string.argtypes = [ctypes.c_int]
    lib.duet_sweep_error_string.restype = ctypes.c_char_p
    return lib


SWEEP_SHAPE_KEYS = ("arm", "rows", "stages", "ctas", "ctas_per_sm",
                    "cluster", "smem_bytes", "copy")
SWEEP_ARMS = ("one_pass", "reread")
SWEEP_COPIES = ("element", "cp.async")


def sweep_launch_shape(R: int, S: int,
                       defines: tuple[str, ...] = ()) -> dict:
    """The shape the sweep kernel launches with for an (R, S) window of
    16-byte aligned inputs on the current CUDA device (for reports; the
    launch decides with the same code): the arm ("one_pass" reads the
    window from HBM once, "reread" reads each row twice), rows a tile, ring
    stages, CTAs in the grid and resident per SM, cluster size, dynamic
    shared memory in bytes, and how a tile is staged: "cp.async" (16-byte
    copies) or "element"."""
    lib = _sweep_library(defines)
    out = (ctypes.c_int * len(SWEEP_SHAPE_KEYS))()
    rc = lib.duet_haplotag_sweep_shape(R, S, out)
    _raise_on(rc, "haplotag_sweep_shape", lib.duet_sweep_error_string)
    shape = dict(zip(SWEEP_SHAPE_KEYS, out))
    shape["arm"] = SWEEP_ARMS[shape["arm"]]
    shape["copy"] = SWEEP_COPIES[shape["copy"]]
    return shape


def build() -> None:
    """Build (or load) the port's four kernel libraries (score, sweep,
    ``ops.pileup_kernel``'s pileup and ``ops.snp_features``' candidate and
    feature passes), their nvcc runs in parallel."""
    from duet_tpu_torch.ops import pileup_kernel, snp_features

    with ThreadPoolExecutor(4) as ex:
        for f in [ex.submit(_score_library), ex.submit(_sweep_library),
                  ex.submit(pileup_kernel.build),
                  ex.submit(snp_features.build)]:
            f.result()


def _raise_on(rc: int, name: str, error_string) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + error_string(rc).decode())


def _device_of(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("the inputs must share one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no haplotag kernel for device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the inputs must be contiguous")
    return dev


def _check_rhs(rhs: torch.Tensor, n_rows: int, n_blocks: int) -> None:
    if rhs.dtype != torch.bfloat16 or rhs.dim() != 2:
        raise TypeError("rhs must be a 2-D bfloat16 tensor")
    if rhs.shape[0] != n_rows:
        raise ValueError(f"rhs has {rhs.shape[0]} rows, want {n_rows}")
    K = rhs.shape[1]
    if K < 3 or not 1 <= n_blocks <= K - 2:
        raise ValueError(f"need K >= 3 and 1 <= n_blocks <= K-2, got K={K}, "
                         f"n_blocks={n_blocks}")


def _score_launch(name: str, fn, lhs_a: torch.Tensor, lhs_b: torch.Tensor,
                  rhs: torch.Tensor, n_tasks: int, n_blocks: int):
    """Launch the score kernel entry `fn` on CUDA tensors; (hap, pc, best)."""
    dev = lhs_a.device
    rows = lhs_a.shape[0]
    # one allocation for the three outputs, addressed by offset: at the
    # pipeline's launch shape the host's work per launch is a large share
    # of the launch
    out = torch.empty((3, rows), dtype=torch.int32, device=dev)
    base = out.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(lhs_a.data_ptr(), lhs_b.data_ptr(), rhs.data_ptr(), base,
                base + 4 * rows, base + 8 * rows, n_tasks, rows // n_tasks,
                lhs_a.shape[1], rhs.shape[1], n_blocks, stream)
    _raise_on(rc, name, _score_library().duet_cuda_error_string)
    _count(name)
    return out.unbind(0)


def _score_batch(name: str, alleles: torch.Tensor, weights16: torch.Tensor,
                 rhs: torch.Tensor, n_tasks: int, n_blocks: int):
    dev = _device_of(alleles, weights16, rhs)
    if alleles.dtype != torch.int8 or alleles.dim() != 2:
        raise TypeError("alleles must be a 2-D int8 tensor")
    if weights16.dtype != torch.bfloat16 or weights16.shape != alleles.shape:
        raise TypeError("weights16 must be bfloat16 with the alleles' shape")
    if n_tasks < 1 or alleles.shape[0] % n_tasks:
        raise ValueError(f"{alleles.shape[0]} rows do not split into "
                         f"{n_tasks} tasks")
    _check_rhs(rhs, n_tasks * alleles.shape[1], n_blocks)
    if dev.type == "cpu":
        return phase_and_tag_batch(alleles, weights16, rhs, n_tasks, n_blocks)
    return _score_launch(name, _score_library().duet_haplotag_score, alleles,
                         weights16, rhs, n_tasks, n_blocks)


def haplotag_score_batch(alleles: torch.Tensor, weights16: torch.Tensor,
                         rhs: torch.Tensor, n_tasks: int, n_blocks: int):
    """Score `n_tasks` stacked (R, S) chunks in one launch.

    alleles   (n_tasks*R, S) int8
    weights16 (n_tasks*R, S) bfloat16
    rhs       (n_tasks*S, K) bfloat16, any K >= 3: per-task [phase |
              informative | block one-hot] stacked on the site axis
    Returns (hap, pc, best), each (n_tasks*R,) int32."""
    return _score_batch("haplotag_score", alleles, weights16, rhs, n_tasks,
                        n_blocks)


def haplotag_score_pre(aw: torch.Tensor, abs_aw: torch.Tensor,
                       rhs: torch.Tensor, n_blocks: int):
    """Score reads on a precomputed aw: the ``_kernel`` launch.

    aw, abs_aw (R, S) bfloat16; rhs (S, K) bfloat16 shared by every row.
    Returns (hap, pc, best), each (R,) int32."""
    dev = _device_of(aw, abs_aw, rhs)
    if aw.dtype != torch.bfloat16 or aw.dim() != 2 or \
            abs_aw.dtype != torch.bfloat16 or abs_aw.shape != aw.shape:
        raise TypeError("aw and abs_aw must be 2-D bfloat16 of one shape")
    _check_rhs(rhs, aw.shape[1], n_blocks)
    if dev.type == "cpu":
        return haplotag_score_plain(aw, abs_aw, rhs, n_blocks)
    return _score_launch("haplotag_score_pre",
                         _score_library().duet_haplotag_score_pre, aw,
                         abs_aw, rhs, 1, n_blocks)


def power_sweep(alleles: torch.Tensor, weights16: torch.Tensor,
                phase: torch.Tensor) -> torch.Tensor:
    """One power-iteration sweep: the ``_sweep_kernel`` launch.

    alleles (R, S) int8 in {-1, 0, +1}; weights16 (R, S) bfloat16 holding
    integer quality weights <= 40; phase (S,) bfloat16 +1/-1/0.  Returns
    the (S,) float32 votes ``aw.T @ sign(aw @ phase)``, exact while 40 * S
    and 40 * R are below 2^24."""
    dev = _device_of(alleles, weights16, phase)
    if alleles.dtype != torch.int8 or alleles.dim() != 2:
        raise TypeError("alleles must be a 2-D int8 tensor")
    if weights16.dtype != torch.bfloat16 or weights16.shape != alleles.shape:
        raise TypeError("weights16 must be bfloat16 with the alleles' shape")
    R, S = alleles.shape
    if phase.dtype != torch.bfloat16 or phase.shape != (S,):
        raise TypeError(f"phase must be a ({S},) bfloat16 tensor")
    if dev.type == "cpu":
        return power_sweep_votes(alleles, weights16, phase)
    votes = sweep_launch(_sweep_library(), alleles, weights16, phase)
    _count("haplotag_sweep")
    return votes.float()


def sweep_launch(lib: ctypes.CDLL, alleles: torch.Tensor,
                 weights16: torch.Tensor,
                 phase: torch.Tensor) -> torch.Tensor:
    """Launch the sweep kernel of `lib` (the library or a build variant of
    it) on checked CUDA tensors; the (S,) int32 votes.  Not counted."""
    dev = alleles.device
    R, S = alleles.shape
    votes = torch.empty(S, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.duet_haplotag_sweep(alleles.data_ptr(), weights16.data_ptr(),
                                     phase.data_ptr(), votes.data_ptr(), R, S,
                                     stream)
    _raise_on(rc, "haplotag_sweep", lib.duet_sweep_error_string)
    return votes


def _rhs(phase: torch.Tensor, block_onehot: torch.Tensor) -> torch.Tensor:
    """The shared bf16 rhs [phase | informative | block one-hot], (S, 2+B)
    zero-padded to a multiple of 8 columns: the score kernel stages rows of
    16-byte multiples with cp.async (columns past 2+B are no block)."""
    S, B = block_onehot.shape
    rhs = torch.zeros((S, -(-(2 + B) // 8) * 8), dtype=torch.bfloat16,
                      device=phase.device)
    rhs[:, 0] = phase
    rhs[:, 1] = phase != 0
    rhs[:, 2:2 + B] = block_onehot
    return rhs


def phase_and_tag_fused(alleles: torch.Tensor, weights16: torch.Tensor,
                        phase0: torch.Tensor, block_onehot: torch.Tensor,
                        sweeps: int = 2) -> dict[str, torch.Tensor]:
    """Phasing power iteration + read scoring over one dense window, on the
    kernels; the counterpart of ``phase_and_tag_fused`` and equal to
    ``ops.haplotag.phase_and_tag`` on hap, pc, best_block and phase.

    alleles (R, S) int8; weights16 (R, S) bfloat16 (integer quality
    weights); phase0 (S,) +1/-1/0; block_onehot (S, B).  Returns hap, pc,
    best_block ((R,) int32) and the refined (S,) int8 phase."""
    if weights16.dtype != torch.bfloat16:
        raise TypeError("weights16 must be bfloat16")
    covered = phase0 != 0
    phase = phase0.to(torch.bfloat16)
    for _ in range(sweeps):
        votes = power_sweep(alleles, weights16, phase)
        new_phase = torch.where(votes > 0, 1.0,
                                torch.where(votes < 0, -1.0, phase.float()))
        phase = torch.where(covered, new_phase, 0.0).to(torch.bfloat16)
    hap, pc, best = _score_batch("haplotag_score_shared", alleles, weights16,
                                 _rhs(phase, block_onehot), 1,
                                 block_onehot.shape[1])
    return {"hap": hap, "pc": pc, "best_block": best,
            "phase": torch.sign(phase).to(torch.int8)}


def haplotag_score(alleles: torch.Tensor, weights: torch.Tensor,
                   phase: torch.Tensor, block_onehot: torch.Tensor):
    """Read scoring over one dense window; the counterpart of
    ``haplotag_score_pallas``.

    alleles (R, S) int8; weights (R, S) float; phase (S,) +1/-1/0;
    block_onehot (S, B).  aw = bf16(bf16(allele) * bf16(weight)) and |aw|
    are formed here, as the JAX function forms them outside its kernel.
    Returns (hap, pc, best_block), each (R,) int32."""
    aw = alleles.to(torch.bfloat16) * weights.to(torch.bfloat16)
    return haplotag_score_pre(aw, aw.abs(), _rhs(phase, block_onehot),
                              block_onehot.shape[1])
