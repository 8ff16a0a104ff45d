"""The explicit device of a run: ``PipelineConfig.device`` / ``--device``.

``cuda`` (the default) puts every device route on the GPU; ``cpu`` runs the
same torch code on the host, which is how the CPU test suite exercises the
device routes.  A ``cuda`` run on a machine without a card raises as soon as
a device route is about to run — it never slides to the CPU.
"""

from __future__ import annotations

import torch

DEVICE_TYPES = ("cuda", "cpu")


def resolve(name: str | torch.device) -> torch.device:
    """torch.device for a ``--device`` value, with TF32 switched off.

    Parity with the JAX package is judged exactly (integer-valued sums) or
    on float32 logits, so neither matmuls nor cuDNN may drop to TF32."""
    dev = torch.device(name)
    if dev.type not in DEVICE_TYPES:
        raise ValueError(f"device must be one of {DEVICE_TYPES}, got {name!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def require(dev: torch.device) -> torch.device:
    """Check that `dev` can run a device route right now."""
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch sees no CUDA device; "
            "pass --device cpu to run the device routes on the host")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
