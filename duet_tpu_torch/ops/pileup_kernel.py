"""Device pileup kernels: ``csrc/pileup.cu`` and its wrappers, the port of
``duet_tpu.ops.pileup._packed_impl`` (which XLA fuses for the TPU).

- ``pileup_count``: expand the packed reads of one window and count them
  into the (4L + 1,) int32 bins (the lanes, ``_hist_counts``).
- ``pileup_call``: call the sites of the bins and compact them into the
  flat int32 readback (``call_sites``, ``jnp.nonzero(size=)`` and its
  gathers).

``ops.pileup.packed_window_body`` runs the two in a row.

On a CUDA tensor each wrapper launches its kernel (built by nvcc at first
use) or raises; on a CPU tensor it runs the kernel's plain torch version
from ``ops.pileup``, which the kernel is pinned bit-equal to.
``LAUNCHES`` counts the launches of each kernel by name.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from duet_tpu_torch.ops.pileup import call_plain, count_plain

KERNELS = ("pileup_count", "pileup_call")
LAUNCHES = dict.fromkeys(KERNELS, 0)
_lock = threading.Lock()
_I32 = torch.int32


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

    lib = load("pileup", ["pileup.cu"])
    lib.duet_pileup_count.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    lib.duet_pileup_count.restype = ctypes.c_int
    lib.duet_pileup_call.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.duet_pileup_call.restype = ctypes.c_int
    for fn in (lib.duet_pileup_count_scratch, lib.duet_pileup_call_scratch):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
    lib.duet_pileup_error_string.argtypes = [ctypes.c_int]
    lib.duet_pileup_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Build (or load) the pileup library."""
    _library()


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + _library().duet_pileup_error_string(rc).decode())


def _device_of(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("the inputs must share one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no pileup kernel for device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the inputs must be contiguous")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def pileup_count(ops4: torch.Tensor, payload_ref: torch.Tensor, *,
                 total: int, length: int) -> torch.Tensor:
    """The (4*length + 1,) int32 bins of one window's `total` lanes, keys
    pos*4 + base, the last bin the sentinel; see ``ops.pileup`` for the
    inputs."""
    dev = _device_of(ops4, payload_ref)
    if ops4.dtype != _I32 or ops4.dim() != 2 or ops4.shape[0] != 4 or \
            ops4.shape[1] < 8:
        raise TypeError("ops4 must be a (4, K >= 8) int32 tensor")
    if payload_ref.dtype != torch.uint8 or payload_ref.dim() != 1:
        raise TypeError("payload_ref must be a 1-D uint8 tensor")
    nb = payload_ref.shape[0] - length
    if length < 1 or nb < 1 or not 0 <= total < 1 << 31 or \
            length > 1 << 28:
        raise ValueError(f"need 1 <= length <= 2^28, a payload before the "
                         f"reference and 0 <= total < 2^31; got length="
                         f"{length}, {nb} payload bytes, total={total}")
    if dev.type == "cpu":
        return count_plain(ops4, payload_ref, total=total, length=length)
    lib = _library()
    K = ops4.shape[1]
    bins = torch.empty(4 * length + 1, dtype=_I32, device=dev)
    scratch = torch.empty(lib.duet_pileup_count_scratch(K), dtype=_I32,
                          device=dev)
    with torch.cuda.device(dev):
        rc = lib.duet_pileup_count(ops4.data_ptr(), K, payload_ref.data_ptr(),
                                   nb, total, length, bins.data_ptr(),
                                   scratch.data_ptr(), _stream(dev))
    _raise_on(rc, "pileup_count")
    _count("pileup_count")
    return bins


def pileup_call(bins: torch.Tensor, ref_codes: torch.Tensor,
                params: torch.Tensor, max_sites: int) -> torch.Tensor:
    """The flat int32 [n_sites, site_idx*max_sites, alt_code*, is_het*,
    depth*, alt_count*] of the (4L + 1,) `bins` against the (L,) uint8
    reference codes, with `params` ops4's row 3."""
    dev = _device_of(bins, ref_codes, params)
    length = ref_codes.shape[0]
    if bins.dtype != _I32 or bins.shape != (4 * length + 1,):
        raise TypeError(f"bins must be ({4 * length + 1},) int32")
    if ref_codes.dtype != torch.uint8 or ref_codes.dim() != 1:
        raise TypeError("ref_codes must be a 1-D uint8 tensor")
    if params.dtype != _I32 or params.dim() != 1 or params.shape[0] < 8:
        raise TypeError("params must be a 1-D int32 tensor of >= 8 slots")
    if not 1 <= length <= 1 << 28 or max_sites < 1:
        raise ValueError(f"need 1 <= L <= 2^28 and max_sites >= 1; got "
                         f"L={length}, max_sites={max_sites}")
    if dev.type == "cpu":
        return call_plain(bins, ref_codes, params, max_sites)
    lib = _library()
    out = torch.empty(1 + 5 * max_sites, dtype=_I32, device=dev)
    scratch = torch.empty(lib.duet_pileup_call_scratch(length), dtype=_I32,
                          device=dev)
    with torch.cuda.device(dev):
        rc = lib.duet_pileup_call(bins.data_ptr(), ref_codes.data_ptr(),
                                  length, params.data_ptr(), max_sites,
                                  out.data_ptr(), scratch.data_ptr(),
                                  _stream(dev))
    _raise_on(rc, "pileup_call")
    _count("pileup_call")
    return out

