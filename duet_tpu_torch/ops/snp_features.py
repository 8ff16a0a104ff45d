"""The neural SNP caller's candidates and feature windows on the card:
``csrc/snp_features.cu`` and its wrappers, with their torch twins.

- ``candidates``: ``models.nn_snp_host.candidate_sites`` of an (L, 4)
  int32 or int64 counts tensor against its (L,) uint8 reference codes:
  (pos int64, alt_code uint8, alt_count int32, depth int64), in ascending
  position order.  On the card the kernels ``cand_count`` (the gate, a bit
  a position, and the scan of the CTAs' counts) and ``cand_compact`` run,
  with one readback of n between them to size the outputs.
- ``features``: ``models.nn_snp_host.extract_features`` of some of those
  candidates, (rows, 51) float32; the kernel ``cand_features``.  The
  caller passes one chunk of candidates at a time, so the card holds one
  chunk's features whatever n is.

On a CUDA tensor each wrapper launches its kernels (built by nvcc at first
use) or raises; on a CPU tensor it runs its twin (``candidates_plain``,
``features_plain``), which the kernels are pinned bit-equal to.  The twins
equal the numpy functions bit for bit where every position's depth is
below 2^24, so that its float32 sum is exact.  Every call owns its outputs
and launches on the current stream, so threads may call at once.
``LAUNCHES`` counts the launches of each kernel by name.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from duet_tpu_torch.models.nn_snp_host import (HALF_WINDOW, N_FEATURES,
                                               N_WINDOW)

KERNELS = ("cand_count", "cand_compact", "cand_features")
LAUNCHES = dict.fromkeys(KERNELS, 0)
_lock = threading.Lock()
_COUNT_TYPES = (torch.int32, torch.int64)


def reset_launches() -> None:
    with _lock:
        for k in KERNELS:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


@functools.cache
def _library() -> ctypes.CDLL:
    from duet_tpu_torch.ops.cuda_build import load

    lib = load("snp_features", ["snp_features.cu"])
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.duet_snp_cand_ctas.argtypes = [i64]
    lib.duet_snp_cand_ctas.restype = i32
    lib.duet_snp_cand_scratch.argtypes = [i64]
    lib.duet_snp_cand_scratch.restype = i64
    lib.duet_snp_cand_count.argtypes = [ptr, i32, ptr, i64, i64, i64, ptr,
                                        ptr]
    lib.duet_snp_cand_count.restype = i32
    lib.duet_snp_cand_compact.argtypes = [ptr, i32, ptr, i64, i64, i64] + \
        [ptr] * 6
    lib.duet_snp_cand_compact.restype = i32
    lib.duet_snp_cand_features.argtypes = [ptr, i32, ptr, i64, ptr, ptr, i32,
                                           ptr, ptr]
    lib.duet_snp_cand_features.restype = i32
    lib.duet_snp_error_string.argtypes = [i32]
    lib.duet_snp_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (or load) the library."""
    _library()


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + _library().duet_snp_error_string(rc).decode())


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_image(counts: torch.Tensor, ref_codes: torch.Tensor
                 ) -> torch.device:
    dev = counts.device
    if ref_codes.device != dev:
        raise ValueError("counts and ref_codes must share one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no SNP feature kernel for device {dev}")
    if counts.dtype not in _COUNT_TYPES or counts.dim() != 2 or \
            counts.shape[1] != 4:
        raise TypeError("counts must be an (L, 4) int32 or int64 tensor")
    if ref_codes.dtype != torch.uint8 or ref_codes.shape != \
            counts.shape[:1]:
        raise TypeError(f"ref_codes must be ({counts.shape[0]},) uint8")
    if not (counts.is_contiguous() and ref_codes.is_contiguous()):
        raise ValueError("counts and ref_codes must be contiguous")
    if counts.shape[0] >= 1 << 31:
        raise ValueError(f"at most 2^31 - 1 positions, got {counts.shape[0]}")
    if dev.type == "cuda" and counts.data_ptr() % 16:
        raise ValueError("counts must be 16-byte aligned on the card")
    return dev


def _first_max(values: torch.Tensor) -> torch.Tensor:
    """The column of each row's first maximum (strict > in column order,
    as np.argmax)."""
    best, arg = values[:, 0], torch.zeros_like(values[:, 0])
    for j in range(1, values.shape[1]):
        better = values[:, j] > best
        best = torch.where(better, values[:, j], best)
        arg = torch.where(better, j, arg)
    return arg


def candidates_plain(counts: torch.Tensor, ref_codes: torch.Tensor,
                     min_depth: int = 3, min_alt: int = 2):
    """``candidate_sites`` in stock torch ops, in int64 as numpy sums."""
    c = counts.long()
    ref_safe = ref_codes.clamp(max=3).long()
    depth = c.sum(1)
    ref_count = c.gather(1, ref_safe[:, None])[:, 0]
    cand = torch.nonzero((depth >= min_depth)
                         & (depth - ref_count >= min_alt)
                         & (ref_codes < 4)).squeeze(1)
    sub = c[cand]
    rs = ref_safe[cand]
    sub[torch.arange(len(cand), device=c.device), rs] = -1
    alt = _first_max(sub)
    alt_count = c[cand, alt]
    keep = (alt_count >= min_alt) & (alt != rs)
    pos = cand[keep]
    return (pos, alt[keep].to(torch.uint8), alt_count[keep].to(torch.int32),
            depth[pos])


def _sum4(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum of the last axis's four values, left to right."""
    return ((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3]


def features_plain(counts: torch.Tensor, ref_codes: torch.Tensor,
                   pos: torch.Tensor, alt_code: torch.Tensor) -> torch.Tensor:
    """``extract_features`` in stock torch ops: the same float32 operations
    (each division IEEE, by a tensor, never by a reciprocal)."""
    n = len(pos)
    dev = counts.device
    pad = torch.zeros((HALF_WINDOW, 4), dtype=torch.float32, device=dev)
    padded = torch.cat([pad, counts.to(torch.float32), pad])
    win = padded[pos[:, None] + torch.arange(N_WINDOW, device=dev)]
    depth = _sum4(win)                                    # (n, W)
    frac = win / depth.clamp(min=1.0)[:, :, None]
    depth_ch = depth.clamp(max=100.0) / torch.full_like(depth, 100.0)
    rows = torch.arange(n, device=dev)
    ref = ref_codes[pos].clamp(max=3).long()
    onehot = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    onehot[rows, ref] = 1.0
    c = counts[pos].to(torch.float32)
    cdepth = _sum4(c).clamp(min=1.0)
    alt = alt_code.long()
    alt_frac = c[rows, alt] / cdepth
    noise = c.clone()
    noise[rows, ref] = 0.0
    noise[rows, alt] = 0.0
    noise_frac = noise.max(dim=1).values / cdepth
    return torch.cat([frac.reshape(n, 4 * N_WINDOW), depth_ch, onehot,
                      alt_frac[:, None], noise_frac[:, None]], dim=1)


def candidates(counts: torch.Tensor, ref_codes: torch.Tensor,
               min_depth: int = 3, min_alt: int = 2):
    """(pos, alt_code, alt_count, depth) of the candidate gate on
    `counts`' device; on the card two kernels and a readback of n."""
    dev = _check_image(counts, ref_codes)
    if dev.type == "cpu":
        return candidates_plain(counts, ref_codes, min_depth, min_alt)
    L = counts.shape[0]
    lib = _library()
    n = 0
    if L:
        scratch = torch.empty(lib.duet_snp_cand_scratch(L),
                              dtype=torch.int32, device=dev)
        args = (counts.data_ptr(), counts.element_size(),
                ref_codes.data_ptr(), L, min_depth, min_alt)
        with torch.cuda.device(dev):
            rc = lib.duet_snp_cand_count(*args, scratch.data_ptr(),
                                         _stream(dev))
        _raise_on(rc, "cand_count")
        _count("cand_count")
        n = int(scratch[lib.duet_snp_cand_ctas(L)])
    pos = torch.empty(n, dtype=torch.int64, device=dev)
    alt_code = torch.empty(n, dtype=torch.uint8, device=dev)
    alt_count = torch.empty(n, dtype=torch.int32, device=dev)
    depth = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        with torch.cuda.device(dev):
            rc = lib.duet_snp_cand_compact(
                *args, scratch.data_ptr(), pos.data_ptr(),
                alt_code.data_ptr(), alt_count.data_ptr(), depth.data_ptr(),
                _stream(dev))
        _raise_on(rc, "cand_compact")
        _count("cand_compact")
    return pos, alt_code, alt_count, depth


def features(counts: torch.Tensor, ref_codes: torch.Tensor,
             pos: torch.Tensor, alt_code: torch.Tensor) -> torch.Tensor:
    """The (rows, 51) float32 features of the candidates at `pos` (int64)
    with `alt_code` (uint8), as ``candidates`` gives them (a window row
    outside [0, L) reads as zeros; the kernel reads alt_code & 3)."""
    dev = _check_image(counts, ref_codes)
    if pos.dtype != torch.int64 or alt_code.dtype != torch.uint8 or \
            pos.dim() != 1 or alt_code.shape != pos.shape:
        raise TypeError("pos must be 1-D int64 and alt_code uint8 of its "
                        "length")
    if pos.device != dev or alt_code.device != dev:
        raise ValueError("the candidates must lie on the counts' device")
    if not (pos.is_contiguous() and alt_code.is_contiguous()):
        raise ValueError("pos and alt_code must be contiguous")
    if len(pos) >= 1 << 31:
        raise ValueError(f"at most 2^31 - 1 rows, got {len(pos)}")
    if dev.type == "cpu":
        return features_plain(counts, ref_codes, pos, alt_code)
    lib = _library()
    out = torch.empty((len(pos), N_FEATURES), dtype=torch.float32,
                      device=dev)
    if len(pos):
        with torch.cuda.device(dev):
            rc = lib.duet_snp_cand_features(
                counts.data_ptr(), counts.element_size(),
                ref_codes.data_ptr(), counts.shape[0], pos.data_ptr(),
                alt_code.data_ptr(), len(pos), out.data_ptr(), _stream(dev))
        _raise_on(rc, "cand_features")
        _count("cand_features")
    return out
