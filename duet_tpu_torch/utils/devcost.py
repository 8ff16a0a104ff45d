"""Per-stage device cost attribution: transfer vs compute vs readback.

The torch twin of ``duet_tpu.utils.devcost`` with its ``_FIELDS``, so
``metrics.json``'s ``device_cost`` block keeps its schema.  Every device
call site splits its work into three timed phases, each a span of
``utils.spans`` (``device.<stage>.h2d``, ``.compute``, ``.d2h``):

  put(stage, device, *arrays)  copy each numpy array or host tensor to
                               `device` and synchronize, one h2d span an
                               array (the worst put is the longest), and
                               count its bytes
  run(stage, device, fn)       call fn and synchronize: one compute span,
                               one dispatch
  get(stage, x)                ``x.cpu().numpy()``: one d2h span, and its
                               bytes
  record(stage, phase, s, n)   a phase that native code timed (the
                               card's BGZF inflate), with its bytes

The synchronize after each phase serializes transfer and compute; that is
the price of attributing them, and ``compute_s`` is time to completion.  On
the CPU the phases are plain copies and calls.  A stage's seconds are
summed over the threads that ran it, so with several threads in flight
they can exceed the stage's wall time.
"""

from __future__ import annotations

import numpy as np
import torch

from duet_tpu_torch.device import require, synchronize
from duet_tpu_torch.utils import spans
from duet_tpu_torch.utils.spans import span

# the fields of duet_tpu.utils.devcost, in its order
_FIELDS = ("h2d_bytes", "h2d_s", "worst_put_s", "n_puts", "compute_s",
           "n_dispatch", "d2h_bytes", "d2h_s")
_PREFIX = "device."


def reset() -> None:
    """Fresh accounting window (the pipeline resets every span at once)."""
    spans.reset(_PREFIX)


def put(stage: str, device: torch.device, *arrays) -> tuple[torch.Tensor, ...]:
    """Copy numpy arrays or host tensors to `device`, timed; returns the
    device tensors in order (a singleton input gives a 1-tuple)."""
    require(device)
    out = []
    for a in arrays:
        with span(f"{_PREFIX}{stage}.h2d"):
            t = a if isinstance(a, torch.Tensor) \
                else torch.from_numpy(np.ascontiguousarray(a))
            d = t.to(device)
            synchronize(device)
        spans.count(f"{_PREFIX}{stage}.h2d_bytes", t.numel() * t.element_size())
        out.append(d)
    return tuple(out)


def run(stage: str, device: torch.device, fn, *args, **kwargs):
    """Run one device computation to completion, charging its wall seconds
    to compute_s and counting one dispatch."""
    with span(f"{_PREFIX}{stage}.compute"):
        out = fn(*args, **kwargs)
        synchronize(device)
    return out


def get(stage: str, x: torch.Tensor) -> np.ndarray:
    """Read one computed tensor back to a numpy array, timed."""
    with span(f"{_PREFIX}{stage}.d2h"):
        out = x.cpu().numpy()
    spans.count(f"{_PREFIX}{stage}.d2h_bytes", out.nbytes)
    return out


def record(stage: str, phase: str, seconds: float, n: int,
           nbytes: int | None = None) -> None:
    """Charge `n` calls and `seconds` of a phase timed in native code (the
    card's BGZF inflater) to ``device.<stage>.<phase>``, and for a copy its
    bytes."""
    spans.add(f"{_PREFIX}{stage}.{phase}", seconds, n)
    if nbytes is not None:
        spans.count(f"{_PREFIX}{stage}.{phase}_bytes", nbytes)


def snapshot() -> dict[str, dict[str, float]]:
    """stage -> rounded cost fields, only stages that dispatched or
    transferred.  Byte and count fields are ints; seconds keep 4 decimals."""
    snap = spans.snapshot(_PREFIX)
    acc: dict[str, dict[str, float]] = {}

    def bucket(stage: str) -> dict[str, float]:
        return acc.setdefault(stage, dict.fromkeys(_FIELDS, 0.0))

    for name, e in snap["spans"].items():
        stage, phase = name[len(_PREFIX):].rsplit(".", 1)
        b = bucket(stage)
        if phase == "h2d":
            b["h2d_s"], b["worst_put_s"], b["n_puts"] = \
                e["s"], e["max_s"], e["n"]
        elif phase == "compute":
            b["compute_s"], b["n_dispatch"] = e["s"], e["n"]
        else:
            b["d2h_s"] = e["s"]
    for name, v in snap["counters"].items():
        stage, field = name[len(_PREFIX):].rsplit(".", 1)
        bucket(stage)[field] = v
    out: dict[str, dict[str, float]] = {}
    for stage, b in acc.items():
        if not any(b.values()):
            continue
        out[stage] = {k: int(v) if k.endswith(("bytes", "puts", "dispatch"))
                      else round(v, 4) for k, v in b.items()}
    return out
