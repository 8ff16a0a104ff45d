"""duet_tpu_torch — the PyTorch/CUDA port of duet_tpu.

The same BAM -> phased_sv.vcf pipeline as ``duet_tpu``, with every device
route written for torch on an NVIDIA GPU (Hopper, sm_90a) instead of JAX on
a TPU.  The layout mirrors ``duet_tpu`` so each module's counterpart is easy
to find:

- ``duet_tpu_torch.device``  — the explicit device choice (``--device``)
- ``duet_tpu_torch.ops``     — device kernels: plain torch versions, plus
                               hand-written CUDA kernels under ``csrc/``
- ``duet_tpu_torch.models``  — the pipeline stages: the device branches,
                               and copies of the host code (``*_host``)
- ``duet_tpu_torch.io``, ``sim``, ``utils`` — copies of duet_tpu's
                               framework-free host layers (BAM/VCF/FASTA
                               I/O, native ingest, the simulator, contig
                               naming, logging, dispatch accounting) plus
                               per-stage device cost accounting
- ``duet_tpu_torch.pipeline`` / ``cli`` — the pipeline and its CLI
- ``duet_tpu_torch.eval``    — the evaluation harness (P/R/F1 of a phased
                               SV callset against a truth VCF)
- ``duet_tpu_torch.tools``   — merge, view, the sweeps, the decision-tree
                               and snp_grid evaluations, and the haplotag
                               crossover timer
- ``duet_tpu_torch.models.nn_snp`` also trains the neural SNP caller
                               (``python -m duet_tpu_torch.models.nn_snp
                               train``)

The package stands alone: it imports nothing of ``duet_tpu`` and no JAX.
Its copies keep duet_tpu's code verbatim but for imports and dropped JAX
branches; the tests hold each copy against its original.
"""

__version__ = "0.1.0"
