"""The (dp, sp) device mesh and the sharded phase-and-tag, in torch.

The port of ``duet_tpu.parallel.mesh``.  As in JAX, the mesh is a grid of
the devices of ONE process:

  mesh axes   ("dp", "sp")
  dp          data parallel over READ batches — shard (i, j) owns row block
              i of the (R x S) allele matrix
  sp          sequence parallel over SNP SITES — shard (i, j) owns column
              block j; site phases and block membership shard along it

  collectives  read scores  : psum over "sp"  (row matvec partials)
               site votes   : psum over "dp"  (column matvec partials)

Shard (i, j) lives on ``mesh.devices[i][j]``.  A device may appear more
than once, so a card's logical shards (``[cuda:0] * 4`` as a 2 x 2 mesh)
run the same code as one shard per card.  JAX's in-graph psum becomes an
explicit reduction over the per-shard tensors: the partials are summed in
shard order on the first shard's device and the sum is put back on every
shard's device.  Every partial is an integer-valued float32 below 2^24, so
the sum is exact in any order and the sharded outputs are bit-identical to
the single-device ``ops.haplotag.phase_and_tag``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from duet_tpu_torch.device import require, resolve
from duet_tpu_torch.ops.haplotag import _aw, _epilogue

# logical devices of a CPU mesh: the count the JAX package's CPU tests
# force (XLA's host platform with 8 devices), so that 'auto' and the
# oversubscription check behave as there
CPU_MESH_DEVICES = 8


@dataclass(frozen=True)
class Mesh:
    """A dp x sp grid of torch devices; ``shape`` as ``jax.sharding.Mesh``'s."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": len(self.devices), "sp": len(self.devices[0])}

    def row(self, i: int) -> tuple[torch.device, ...]:
        """The sp devices of data-parallel row i."""
        return self.devices[i]

    def column(self, j: int) -> tuple[torch.device, ...]:
        """The dp devices of sequence-parallel column j."""
        return tuple(r[j] for r in self.devices)


def local_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """This process's devices of `device`'s type: every visible card, or
    CPU_MESH_DEVICES logical CPU devices."""
    dev = resolve(device)
    if dev.type == "cpu":
        return [dev] * CPU_MESH_DEVICES
    require(dev)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(dp: int | None = None, sp: int = 1,
              devices: list | None = None) -> Mesh:
    """Build a (dp, sp) mesh from `devices` (default: every visible card),
    taking the first dp * sp.  With no dp, every device goes to the
    data-parallel axis."""
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else local_devices("cuda"))]
    if dp is None:
        dp = len(devs) // sp
    if dp < 1 or sp < 1 or dp * sp > len(devs):
        raise ValueError(f"a {dp} x {sp} mesh needs {dp * sp} devices, "
                         f"have {len(devs)}")
    return Mesh(tuple(tuple(devs[i * sp:(i + 1) * sp]) for i in range(dp)))


def pad_to_multiple(arr: np.ndarray, mult: int, axis: int) -> np.ndarray:
    """Zero-pad `axis` up to a multiple of `mult` (shard-divisibility)."""
    size = arr.shape[axis]
    pad = (-size) % mult
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths)


def psum(parts: list[torch.Tensor],
         devices: tuple[torch.device, ...]) -> list[torch.Tensor]:
    """All-reduce of one mesh axis: the parts summed in shard order on the
    first shard's device, the sum placed on each shard's device."""
    total = parts[0].to(devices[0])
    for p in parts[1:]:
        total = total + p.to(devices[0])
    return [total.to(d) for d in devices]


def _as_tensor(x, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def phase_and_tag_sharded(mesh: Mesh, alleles, weights, phase0, block_onehot,
                          sweeps: int = 2):
    """Mesh-sharded equivalent of ``ops.haplotag.phase_and_tag``.

    alleles/weights (R, S), numpy or tensors, with R divisible by the
    mesh's dp size and S by its sp size (use pad_to_multiple); phase0
    (S,); block_onehot (S, B), replicated over dp and split over sp on the
    site axis.  Returns (hap, pc, best_block, phase): (R,) int32 each and
    the (S,) int8 refined phase, on the mesh's first device.
    """
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    R, S = alleles.shape
    if R % dp or S % sp:
        raise ValueError(f"shape {tuple(alleles.shape)} not divisible by "
                         f"mesh {dp}x{sp}")
    r, s = R // dp, S // sp
    resolve(mesh.devices[0][0])      # TF32 off: the products must be exact
    a, w = _as_tensor(alleles), _as_tensor(weights)
    ph0 = _as_tensor(phase0, torch.float32)
    oh = _as_tensor(block_onehot)
    aw = [[None] * sp for _ in range(dp)]
    ph = [[None] * sp for _ in range(dp)]
    for i in range(dp):
        for j in range(sp):
            d = mesh.devices[i][j]
            rows, cols = slice(i * r, (i + 1) * r), slice(j * s, (j + 1) * s)
            aw[i][j] = _aw(a[rows, cols].to(d), w[rows, cols].to(d))
            ph[i][j] = ph0[cols].to(d).to(torch.bfloat16).float()
    covered = [[ph[i][j] != 0 for j in range(sp)] for i in range(dp)]

    def row_sums(lhs, rhs):
        """psum over sp of each shard's lhs @ rhs: [i][j] on devices[i][j]."""
        return [psum([lhs[i][j] @ rhs[i][j] for j in range(sp)],
                     mesh.row(i)) for i in range(dp)]

    for _ in range(sweeps):
        signed = row_sums(aw, ph)
        h = [[torch.sign(signed[i][j]) for j in range(sp)] for i in range(dp)]
        votes = [psum([aw[i][j].T @ h[i][j] for i in range(dp)],
                      mesh.column(j)) for j in range(sp)]
        for i in range(dp):
            for j in range(sp):
                v, p = votes[j][i], ph[i][j]
                new = torch.where(v > 0, 1.0, torch.where(v < 0, -1.0, p))
                ph[i][j] = torch.where(covered[i][j], new, 0.0)

    signed = row_sums(aw, ph)
    rhs = [[torch.cat([(ph[i][j] != 0).float()[:, None],
                       oh[j * s:(j + 1) * s].to(mesh.devices[i][j])
                       .to(torch.bfloat16).float()], dim=1)
            for j in range(sp)] for i in range(dp)]
    rest = row_sums([[x.abs() for x in row] for row in aw], rhs)
    first = mesh.devices[0][0]
    outs = [_epilogue(signed[i][0], rest[i][0][:, 0], rest[i][0][:, 1:])
            for i in range(dp)]
    hap, pc, best = (torch.cat([o[k].to(first) for o in outs])
                     for k in range(3))
    phase = torch.cat([torch.sign(ph[0][j]).to(first)
                       for j in range(sp)]).to(torch.int8)
    return hap, pc, best, phase
