"""Multi-process runtime: torch.distributed wiring and the read-batch plan.

The port of ``duet_tpu.parallel.distributed``.  JAX's multi-host recipe
becomes torch.distributed on the gloo backend, which runs over TCP on any
host, card or not:

  1. every process calls ``init_distributed(coordinator, n, pid)``;
     process 0's HOST:PORT is the rendezvous address
  2. ``global_mesh(sp=...)`` builds a (dp, sp) mesh over THIS process's
     devices (``parallel.mesh``).  A mesh that spans processes is not
     ported: duet_tpu's pipeline never composes one with a working
     collective, since each process owns other contigs and exchanges its
     results as part files
  3. each process takes its own read batches (``host_read_batches``)
  4. ``gather_rows`` all-gathers each process's rows for the single
     writer on process 0

A single process skips the initialisation, and ``gather_rows`` is then the
identity.
"""

from __future__ import annotations

import atexit

import numpy as np
import torch

from duet_tpu_torch.parallel.mesh import Mesh, local_devices, make_mesh


def _world() -> tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join the gloo process group at tcp://`coordinator_address` (a no-op
    for a single process, or when this process has joined already).  torch
    detects no cluster environment, so the address, the process count and
    this process's id are all required."""
    import torch.distributed as dist

    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs --coordinator, "
                         "--num-processes and --process-id")
    dist.init_process_group("gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    # as jax.distributed does: leave the group before the interpreter
    # exits; a gloo group still alive at exit can abort the process
    # ("terminate called without an active exception") after its work
    # is done
    atexit.register(_leave_group)


def _leave_group() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(sp: int = 1, device: str | torch.device = "cuda") -> Mesh:
    """(dp, sp) mesh over this process's devices of `device`'s type."""
    devs = local_devices(device)
    n = len(devs)
    if n % sp:
        raise ValueError(f"{n} devices not divisible by sp={sp}")
    return make_mesh(dp=n // sp, sp=sp, devices=devs)


def host_read_batches(n_reads: int, batch: int,
                      process_id: int | None = None,
                      num_processes: int | None = None):
    """Row ranges of the read axis owned by this process: contiguous
    round-robin batches so coordinate locality is preserved per batch."""
    rank, world = _world()
    pid = rank if process_id is None else process_id
    np_ = world if num_processes is None else num_processes
    out = []
    for start in range(pid * batch, n_reads, batch * np_):
        out.append((start, min(start + batch, n_reads)))
    return out


def gather_rows(mesh: Mesh | None, local_rows: np.ndarray) -> np.ndarray:
    """All-gather each process's row block, concatenated in rank order on
    axis 0 (every process's block has the same shape).  The identity for
    a single process."""
    import torch.distributed as dist

    _, world = _world()
    if world == 1:
        return np.asarray(local_rows)
    mine = torch.from_numpy(np.ascontiguousarray(local_rows))
    blocks = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(blocks, mine)
    return torch.cat(blocks).numpy()
