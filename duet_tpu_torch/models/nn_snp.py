"""The neural pileup SNP caller as a torch ``nn.Module``, and its trainer.

Port of ``duet_tpu.models.nn_snp``: the same 51 -> 64 -> 64 -> 3 MLP over
the same features (``extract_features``), with the shipped weights (a copy
in ``duet_tpu_torch/models/weights/``) loaded by ``load_params`` (both in
``nn_snp_host``) and carried into PyTorch's layout by ``params_from_numpy``
(``params_to_numpy`` carries them back).  Classes: 0 non-variant, 1 het,
2 hom-alt.

``train`` fits the network on the simulator's corpus (``build_training_set``)
on a torch device, with the JAX package's loss, class weights, batch size and
Adam settings, and saves duet_tpu's ``.npz`` layout:

    python -m duet_tpu_torch.models.nn_snp train OUT.npz [--steps N]
        [--device cuda|cpu]

Batches come from a seeded ``torch.Generator``, not JAX's threefry stream, so
the weights are not duet_tpu's bytes; a trained model is judged on the
snp_grid F1 table (``tools/snp_grid.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from duet_tpu_torch.device import DEVICE_TYPES, require, resolve
from duet_tpu_torch.models.nn_snp_host import (
    DEFAULT_WEIGHTS,
    HIDDEN,
    N_CLASSES,
    N_FEATURES,
    apply_np,
    build_training_set,
    candidate_sites,
    extract_features,
    init_params,
    load_params,
    save_params,
)
from duet_tpu_torch.utils.spans import span


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


def params_to_numpy(model: SnpMLP) -> dict[str, np.ndarray]:
    """The inverse of ``params_from_numpy``: the model's parameters as the
    JAX package's float32 arrays (W1..W3 as (in, out), b1..b3)."""
    out = {}
    for k, layer in enumerate((model.fc1, model.fc2, model.fc3), 1):
        out[f"W{k}"] = np.ascontiguousarray(
            layer.weight.detach().cpu().numpy().T, np.float32)
        out[f"b{k}"] = layer.bias.detach().cpu().numpy().astype(np.float32)
    return out


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
    pass per `batch` candidates on `device` (the spans
    ``snp_calling.features`` and ``snp_calling.network``)."""
    from duet_tpu_torch.models.snp_caller_host import ContigSnps

    with span("snp_calling.features"):
        pos, alt_code, alt_count, depth = candidate_sites(counts, ref_codes)
        feats = extract_features(counts, ref_codes, pos, alt_code)
    n = len(pos)
    cls = np.zeros(0, dtype=np.int64)
    if n:
        require(device)
        with span("snp_calling.network"):
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


def weighted_nll(model: SnpMLP, x: torch.Tensor, y: torch.Tensor,
                 class_w: torch.Tensor) -> torch.Tensor:
    """The training loss of ``duet_tpu.models.nn_snp.train``: the
    class-weighted NLL ``(nll * w).sum() / w.sum()`` with ``w =
    class_w[y]``, which ``F.cross_entropy(weight=)`` computes exactly."""
    return F.cross_entropy(model(x), y, weight=class_w)


def train(out_path: str, steps: int = 1200, lr: float = 3e-3, seed: int = 0,
          log=print, device: torch.device = torch.device("cuda")
          ) -> dict[str, np.ndarray]:
    """Fit the MLP on ``build_training_set()`` on `device` and save it to
    `out_path`; mirrors ``duet_tpu.models.nn_snp.train``.

    The loss is ``weighted_nll`` with sqrt-inverse-frequency class
    weights, the optimizer Adam(lr) with optax's defaults (betas 0.9 and
    0.999, eps 1e-8 outside the square root), each step a batch of
    min(16384, n) rows drawn with replacement from a generator seeded with
    `seed`.  The corpus goes to the device once.  A ``cuda`` device on a
    host without a card raises before any work."""
    device = require(resolve(device))
    X, y = build_training_set()
    n = len(y)
    counts = np.bincount(y, minlength=N_CLASSES).astype(np.float64)
    # sqrt of inverse frequency: enough lift for the rare het/hom classes
    # without sacrificing non-variant precision (full inverse-frequency
    # weighting over-calls at low coverage)
    class_w = np.sqrt(n / np.maximum(counts, 1.0) / N_CLASSES).astype(
        np.float32)
    log(f"training set: {n} candidates, class counts {counts.tolist()}")

    model = params_from_numpy(init_params(seed)).to(device).train()
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    Xd = torch.from_numpy(X).to(device)
    yd = torch.from_numpy(y).to(device)
    wd = torch.from_numpy(class_w).to(device)
    batch = min(16384, n)
    gen = torch.Generator(device).manual_seed(seed)
    for i in range(steps):
        idx = torch.randint(0, n, (batch,), generator=gen, device=device)
        loss = weighted_nll(model, Xd[idx], yd[idx], wd)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % 100 == 0 or i == steps - 1:
            log(f"step {i}: loss {loss.item():.4f}")
    out = params_to_numpy(model)
    pred = apply_np(out, X).argmax(axis=1)
    for c, name in enumerate(("nonvar", "het", "hom")):
        m = y == c
        acc = float((pred[m] == c).mean()) if m.any() else float("nan")
        log(f"train recall[{name}] = {acc:.4f}")
    save_params(out_path, out)
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m duet_tpu_torch.models.nn_snp",
        description="train the neural pileup SNP caller on simulated data")
    ap.add_argument("command", choices=["train"])
    ap.add_argument("out", nargs="?", default=DEFAULT_WEIGHTS)
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--device", choices=DEVICE_TYPES, default="cuda",
                    help="where the training steps run (default cuda; a "
                         "host without a card must pass cpu)")
    args = ap.parse_args(argv)
    train(args.out, steps=args.steps, device=resolve(args.device))
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
