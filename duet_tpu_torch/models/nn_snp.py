"""The neural pileup SNP caller as a torch ``nn.Module``.

Port of the inference half of ``duet_tpu.models.nn_snp``: the same 51 -> 64
-> 64 -> 3 MLP over the same features (``extract_features``), with the
shipped weights (a copy in ``duet_tpu_torch/models/weights/``) loaded by
``load_params`` (both in ``nn_snp_host``) and carried into PyTorch's layout by
``params_from_numpy``.  Classes: 0 non-variant, 1 het, 2 hom-alt.
Training stays in the JAX package for now.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from duet_tpu_torch.models.nn_snp_host import (
    HIDDEN,
    N_CLASSES,
    N_FEATURES,
    candidate_sites,
    extract_features,
    load_params,
)


class SnpMLP(nn.Module):
    """Two ReLU hidden layers over the 51 pileup-window features."""

    def __init__(self) -> None:
        super().__init__()
        self.fc1 = nn.Linear(N_FEATURES, HIDDEN)
        self.fc2 = nn.Linear(HIDDEN, HIDDEN)
        self.fc3 = nn.Linear(HIDDEN, N_CLASSES)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.fc1(x))
        h = torch.relu(self.fc2(h))
        return self.fc3(h)


def params_from_numpy(params: dict[str, np.ndarray]) -> SnpMLP:
    """SnpMLP holding the JAX package's parameters (W1..W3 as (in, out)
    matrices, b1..b3 vectors); ``Linear.weight`` is each W transposed."""
    model = SnpMLP()
    with torch.no_grad():
        for k, layer in enumerate((model.fc1, model.fc2, model.fc3), 1):
            W = torch.from_numpy(np.asarray(params[f"W{k}"], np.float32))
            layer.weight.copy_(W.T)
            layer.bias.copy_(torch.from_numpy(
                np.asarray(params[f"b{k}"], np.float32)))
    return model.eval()


def load_model(path: str | None = None,
               device: torch.device = torch.device("cpu")) -> SnpMLP:
    """The shipped weights (``models/weights/nn_snp_v2.npz``, or
    `path`) as an SnpMLP on `device`."""
    return params_from_numpy(load_params(path)).to(device)


def nn_call_snps(contig: str, counts: np.ndarray, ref_codes: np.ndarray,
                 model: SnpMLP | None = None,
                 device: torch.device = torch.device("cpu"),
                 batch: int = 65536):
    """ContigSnps via the network (drop-in for snp_caller.call_snps).

    Mirrors ``duet_tpu.models.nn_snp.nn_call_snps``: candidate sites from
    the candidate gate, features from the extractor, then one forward
    pass per `batch` candidates on `device`."""
    from duet_tpu_torch.models.snp_caller_host import ContigSnps
    from duet_tpu_torch.device import require

    pos, alt_code, alt_count, depth = candidate_sites(counts, ref_codes)
    feats = extract_features(counts, ref_codes, pos, alt_code)
    n = len(pos)
    cls = np.zeros(0, dtype=np.int64)
    if n:
        require(device)
        model = model if model is not None else load_model(device=device)
        chunks = []
        with torch.no_grad():
            for s in range(0, n, batch):
                x = torch.from_numpy(feats[s:s + batch]).to(device)
                chunks.append(model(x).argmax(dim=1).cpu().numpy())
        cls = np.concatenate(chunks)
    keep = cls >= 1
    return ContigSnps(
        contig=contig,
        pos=pos[keep],
        ref_code=ref_codes[pos[keep]].astype(np.uint8),
        alt_code=alt_code[keep],
        is_het=cls[keep] == 1,
        depth=depth[keep].astype(np.int32),
        alt_count=alt_count[keep].astype(np.int32),
    )
