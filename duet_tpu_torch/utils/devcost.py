"""Per-stage device cost attribution: transfer vs compute vs readback.

The torch twin of ``duet_tpu.utils.devcost`` with its ``_FIELDS``, so
``metrics.json``'s ``device_cost`` block keeps its schema.  Every device
call site splits its work into three timed phases:

  put(stage, device, *arrays)  copy each numpy array or host tensor to
                               `device` and synchronize; charge wall seconds
                               and bytes to h2d, and track the worst put
  run(stage, device, fn)       call fn and synchronize; charge wall seconds
                               to compute and count one dispatch
  get(stage, x)                ``x.cpu().numpy()``: d2h seconds and bytes

The synchronize after each phase serializes transfer and compute; that is
the price of attributing them.  On the CPU the phases are plain copies and
calls.  Thread-safe: the stages fan contigs out over thread pools, and a
stage's seconds are summed over its threads, so with several threads in
flight they can exceed the stage's wall time.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from duet_tpu_torch.device import require, synchronize

# the fields of duet_tpu.utils.devcost, in its order
_FIELDS = ("h2d_bytes", "h2d_s", "worst_put_s", "n_puts", "compute_s",
           "n_dispatch", "d2h_bytes", "d2h_s")

_lock = threading.Lock()
_acc: dict[str, dict[str, float]] = {}


def _bucket(stage: str) -> dict[str, float]:
    b = _acc.get(stage)
    if b is None:
        b = _acc[stage] = {k: 0.0 for k in _FIELDS}
    return b


def reset() -> None:
    """Fresh accounting window (one per pipeline run)."""
    with _lock:
        _acc.clear()


def put(stage: str, device: torch.device, *arrays) -> tuple[torch.Tensor, ...]:
    """Copy numpy arrays or host tensors to `device`, timed; returns the
    device tensors in order (a singleton input gives a 1-tuple)."""
    require(device)
    out = []
    for a in arrays:
        t0 = time.perf_counter()
        t = a if isinstance(a, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(a))
        d = t.to(device)
        synchronize(device)
        dt = time.perf_counter() - t0
        with _lock:
            b = _bucket(stage)
            b["h2d_bytes"] += t.numel() * t.element_size()
            b["h2d_s"] += dt
            b["n_puts"] += 1
            b["worst_put_s"] = max(b["worst_put_s"], dt)
        out.append(d)
    return tuple(out)


def run(stage: str, device: torch.device, fn, *args, **kwargs):
    """Run one device computation to completion, charging its wall seconds
    to compute_s and counting one dispatch."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    synchronize(device)
    dt = time.perf_counter() - t0
    with _lock:
        b = _bucket(stage)
        b["compute_s"] += dt
        b["n_dispatch"] += 1
    return out


def get(stage: str, x: torch.Tensor) -> np.ndarray:
    """Read one computed tensor back to a numpy array, timed."""
    t0 = time.perf_counter()
    out = x.cpu().numpy()
    dt = time.perf_counter() - t0
    with _lock:
        b = _bucket(stage)
        b["d2h_bytes"] += out.nbytes
        b["d2h_s"] += dt
    return out


def snapshot() -> dict[str, dict[str, float]]:
    """stage -> rounded cost fields, only stages that dispatched or
    transferred.  Byte and count fields are ints; seconds keep 4 decimals."""
    with _lock:
        items = {s: dict(b) for s, b in _acc.items()}
    out: dict[str, dict[str, float]] = {}
    for stage, b in items.items():
        if not any(b.values()):
            continue
        out[stage] = {k: int(v) if k.endswith(("bytes", "puts", "dispatch"))
                      else round(v, 4) for k, v in b.items()}
    return out
