"""duet_tpu_torch — the PyTorch/CUDA port of duet_tpu.

The same BAM -> phased_sv.vcf pipeline as ``duet_tpu``, with every device
route written for torch on an NVIDIA GPU (Hopper, sm_90a) instead of JAX on
a TPU.  The layout mirrors ``duet_tpu`` so each module's counterpart is easy
to find:

- ``duet_tpu_torch.device``  — the explicit device choice (``--device``)
- ``duet_tpu_torch.ops``     — device kernels: plain torch versions, plus
                               hand-written CUDA kernels under ``csrc/``
- ``duet_tpu_torch.models``  — the device branches of the pipeline stages
- ``duet_tpu_torch.utils``   — per-stage device cost accounting
- ``duet_tpu_torch.pipeline`` / ``cli`` — the batch pipeline and its CLI

Framework-free host layers (``io``, ``native`` ingest, ``sim``, ``eval``,
the numpy stage code) are imported from ``duet_tpu``, never copied; this
package imports no JAX.
"""

__version__ = "0.1.0"
