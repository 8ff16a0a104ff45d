"""Device glue of the SNP-phasing stage: refine on torch, then score the
reads of every contig in one batch (``score_contigs_batched``, the batch
pipeline) or of one contig (``phase_contig``, the streaming pipeline).

The allele matrix, initial phasing, weak-junction splitting, the host
scorers and the sparse scorer's epilogue are the port's copies of
``duet_tpu.models.snp_phaser``'s (``snp_phaser_host``); the switch
correction is ``SwitchCorrector``, the host copy's by local updates.  The
single-device read scorer is a `mode` (default ``HAPLOTAG_DEVICE_MODE``):

- ``"sparse"`` (auto's, and duet_tpu's default): the COO scatter scorer
  ``ops.sparse_power.haplotag_score_sparse_multi``, one launch for a batch
  of contigs;
- ``"dense"`` (the pipeline's under --device-stages on): the windowed
  route — reads are cut into fixed 256-row chunks per site window, their
  tiles built on the device, and ``HAPLOTAG_BATCH`` chunks go to the CUDA
  kernel ``ops.haplotag_kernel.haplotag_score_batch`` per launch.

Under a device mesh (``phase_contig(mesh=...)``) the dense windows go to
the sharded ``parallel.mesh.phase_and_tag_sharded`` instead, as in
duet_tpu, whose mesh route runs no Pallas kernel either.

Both are pinned bit-identical to the host scorer ``_haplotag``.

``write_phased_snp_vcf`` writes the host copy's bytes from the sites'
columns and indexes the file from its writer's offsets.
"""

from __future__ import annotations

import numpy as np
import torch

from duet_tpu_torch.io.vcf import write_vcf_indexed
from duet_tpu_torch.models.snp_caller_host import BASES, ContigSnps
from duet_tpu_torch.models.snp_phaser_host import (
    HAPLOTAG_B,
    HAPLOTAG_BATCH,
    REFINE_CORRECT_ROUNDS,
    AlleleMatrix,
    PhaseResult,
    _as_result,
    _finish_scored,
    _haplotag,
    _initial_phase,
    _power_refine,
    _scatter_tagged,
    _split_weak_junctions,
    _switch_correct,
    build_allele_matrix,
)
from duet_tpu_torch.utils.spans import count, span

# auto's read scorer: the one whose route beat the host's from the lower
# size, or on a tie the faster past it (route_crossover run twice in one
# call, NVIDIA H100 80GB HBM3, 700.00 W, refine included; PERF.md §5):
# sparse from 24,993 and 49,995 nnz, dense from 49,995 in both; the sparse
# scorer faster than the dense at every size from 2k to 800k nnz
# (0.0167-0.0214 against 0.0181-0.0244 s at 799,992).  --device-stages on,
# which forces every device route, scores with the dense route and its
# hand kernel (pipeline.PipelineConfig.haplotag_mode).
HAPLOTAG_DEVICE_MODE = "sparse"
CHUNK = 256            # read rows per scoring task
_CPU = torch.device("cpu")


def _untagged(n: int):
    """(hap, ps, pc) of `n` reads, none tagged."""
    return (np.zeros(n, dtype=np.int8), np.full(n, -1, dtype=np.int64),
            np.full(n, -1, dtype=np.int32))


def _haplotag_sparse_device(am: AlleleMatrix, phase: np.ndarray,
                            block_id: np.ndarray, block_ps: np.ndarray,
                            device: torch.device = _CPU):
    """Whole-contig device scoring over the COO (``ops.sparse_power``);
    reads spanning more than SLOT_K phase-set blocks fall back to the host
    path.  Mirrors ``duet_tpu.models.snp_phaser._haplotag_sparse_device``."""
    from duet_tpu_torch.ops.sparse_power import (INT32_EXACT_NNZ,
                                                 haplotag_score_sparse)

    if am.n_sites == 0 or len(am.row) == 0 or len(block_ps) == 0:
        return _untagged(am.n_reads)
    if len(am.row) > INT32_EXACT_NNZ:
        # a batch-size bound: larger inputs take the host path
        return _haplotag(am, phase, block_id, block_ps)
    return _finish_scored(am, phase, block_id, block_ps,
                          haplotag_score_sparse(am, phase, block_id, device))


def _haplotag_device(am: AlleleMatrix, phase: np.ndarray,
                     block_id: np.ndarray, block_ps: np.ndarray,
                     window: int = 2048, halo: int = 256, mesh=None,
                     batch: int = HAPLOTAG_BATCH, mode: str | None = None,
                     device: torch.device = _CPU):
    """Device read scoring (K1); mirrors
    ``duet_tpu.models.snp_phaser._haplotag_device``.  `mode` (default
    HAPLOTAG_DEVICE_MODE) picks the sparse COO scorer or the dense windowed
    route (``_haplotag_dense_device``).  With `mesh` every window chunk
    goes through the mesh-sharded ``parallel.mesh.phase_and_tag_sharded``
    instead (``_haplotag_mesh``).

    Sites split into windows of `window` columns plus a `halo` overlap;
    each read is scored in the window of its first observation.  Reads
    spanning past the halo, and windows with more than HAPLOTAG_B
    phase-set blocks, take the host scorer, so outputs equal _haplotag."""
    if mesh is not None:
        return _haplotag_mesh(am, phase, block_id, block_ps, window, halo,
                              mesh)
    if (mode or HAPLOTAG_DEVICE_MODE) == "sparse":
        return _haplotag_sparse_device(am, phase, block_id, block_ps, device)
    return _haplotag_dense_device(am, phase, block_id, block_ps, window, halo,
                                  batch, device)


def _host_score_rows(am: AlleleMatrix, phase, block_id, block_ps,
                     wide: np.ndarray, tagging) -> None:
    """Score the reads `wide` (over-spanning reads, over-full windows) with
    the host scorer into `tagging`."""
    if not len(wide):
        return
    read_hap, read_ps, read_pc = tagging
    sub = np.isin(am.row, wide)
    sub_am = AlleleMatrix(am.n_reads, am.n_sites, am.site_pos, am.row[sub],
                          am.col[sub], am.allele[sub], am.weight[sub])
    h, p, c = _haplotag(sub_am, phase, block_id, block_ps)
    read_hap[wide] = h[wide]
    read_ps[wide] = p[wide]
    read_pc[wide] = c[wide]


def _haplotag_dense_device(am: AlleleMatrix, phase: np.ndarray,
                           block_id: np.ndarray, block_ps: np.ndarray,
                           window: int, halo: int, batch: int,
                           device: torch.device):
    """The dense windowed route on one device, its tiles built there.

    The COO goes to `device` once.  There, torch ops give every read its
    window and halo test, and every observation its row among the stacked
    256-row chunks of the windows and its column in its window; each launch
    then fills its (batch*256, S_w) int8 alleles and bfloat16 weights by
    scattering its observations into zeroed tensors, gathers the rhs
    [phase | informative | block one-hot] of each chunk's window, and runs
    ``ops.haplotag_kernel.haplotag_score_batch``: `batch` chunks a launch,
    in window order, as duet_tpu flushes them.  The host keeps what is per
    window: each window's phase-set blocks, the over-full windows, and the
    scatter of the scores back to the reads.  A (read, site) cell observed
    twice keeps its last observation, as duet_tpu's numpy tiles do."""
    from duet_tpu_torch.ops.haplotag_kernel import haplotag_score_batch
    from duet_tpu_torch.utils import devcost, dispatch

    n, m = am.n_reads, am.n_sites
    tagging = _untagged(n)
    if m == 0 or len(am.row) == 0:
        return tagging
    S_w = -(-(window + halo) // 128) * 128   # 128-lane-aligned site axis
    K = 2 + HAPLOTAG_B
    n_win = -(-m // window)
    rows = CHUNK * batch                     # rows of one launch
    row, col, allele, weight = devcost.put("haplotag", device, am.row,
                                           am.col, am.allele, am.weight)

    def assign_reads():
        r, c = row.long(), col.long()
        first = torch.full((n,), m, dtype=torch.int64, device=device)
        first.scatter_reduce_(0, r, c, "amin")
        last = torch.full((n,), -1, dtype=torch.int64, device=device)
        last.scatter_reduce_(0, r, c, "amax")
        has = last >= 0
        w_read = torch.where(has, first // window, -1)
        span_ok = has & (last < (w_read + 1) * window + halo)
        # window n_win collects the reads that no window scores
        win = torch.where(span_ok, w_read, n_win)
        order = torch.sort(win, stable=True).indices   # by window, then read
        counts = torch.bincount(win, minlength=n_win + 1)
        return win, order, counts, torch.nonzero(has & ~span_ok).flatten()

    win_d, order_d, counts_d, wide_d = devcost.run("haplotag", device,
                                                   assign_reads)
    counts = devcost.get("haplotag", counts_d)[:n_win]
    order = devcost.get("haplotag", order_d)
    wide = devcost.get("haplotag", wide_d)
    wstart = np.cumsum(counts) - counts    # each window's reads in `order`

    # the block table of every window that holds reads: present[i] is
    # uk[p0[i]:p0[i] + n_present[i]] % nb, and bcol each site's column in it
    wins = np.flatnonzero(counts)
    s = np.arange(S_w)
    sites = wins[:, None] * window + s
    valid = (s < window + halo) & (sites < m)
    at = np.minimum(sites, m - 1)
    blk = np.where(valid, block_id[at], -1).astype(np.int64)
    covered = blk >= 0
    nb = int(blk.max()) + 1 if covered.any() else 1
    key = np.arange(len(wins))[:, None] * nb + blk
    uk = np.unique(key[covered])
    n_present = np.bincount(uk // nb, minlength=len(wins))
    p0 = np.cumsum(n_present) - n_present
    over = n_present > HAPLOTAG_B
    host_rows = [order[wstart[w]:wstart[w] + counts[w]] for w in wins[over]]
    dev = np.flatnonzero(~over)    # the windows (into wins) scored here
    if len(dev):
        dw = wins[dev]
        n_ch = -(-counts[dw] // CHUNK)
        ch0 = np.cumsum(n_ch) - n_ch       # each window's first chunk
        n_chunks = int(n_ch.sum())
        n_launch = -(-n_chunks // batch)
        chunk_base = np.full(n_win + 1, -1, dtype=np.int64)
        chunk_base[dw] = ch0
        start = np.zeros(n_win + 1, dtype=np.int64)
        start[:n_win] = wstart
        ph = np.where(valid, phase[at], 0)[dev].astype(np.int8)
        bcol = np.where(covered, np.searchsorted(uk, key) - p0[:, None],
                        -1)[dev]
        # the window of every chunk slot; padding slots take the zero rhs
        chunk_win = np.full(n_launch * batch, len(dev), dtype=np.int64)
        chunk_win[:n_chunks] = np.repeat(np.arange(len(dev)), n_ch)
        base_d, start_d, ph_d, bcol_d, cwin_d = devcost.put(
            "haplotag", device, chunk_base, start, ph, bcol, chunk_win)
        end = n_launch * rows * S_w

        def tiles():
            r = row.long()
            w = win_d[r]
            pos = torch.empty_like(order_d).scatter_(
                0, order_d, torch.arange(n, device=device))
            base = base_d[w]
            cell = (base * CHUNK + pos[r] - start_d[w]) * S_w \
                + col.long() - w * window
            cell = torch.where(base >= 0, cell, end)
            cell, idx = torch.sort(cell, stable=True)
            keep = cell < end
            keep[:-1] &= cell[1:] != cell[:-1]
            cell, idx = cell[keep], idx[keep]
            bounds = torch.searchsorted(cell, torch.arange(
                n_launch + 1, device=device) * (rows * S_w))
            rhs = torch.zeros((len(dev) + 1, S_w, K), dtype=torch.bfloat16,
                              device=device)
            rhs[:-1, :, 0] = ph_d
            rhs[:-1, :, 1] = (ph_d != 0).to(torch.bfloat16)
            i, j = torch.nonzero(bcol_d >= 0, as_tuple=True)
            rhs[i, j, 2 + bcol_d[i, j]] = 1
            return (cell, allele[idx], weight[idx].to(torch.bfloat16),
                    bounds, rhs)

        cell, a_v, w_v, bounds_d, rhs = devcost.run("haplotag", device, tiles)
        bounds = devcost.get("haplotag", bounds_d)

        def launch(f: int, lo: int, hi: int):
            flat = cell[lo:hi] - f * rows * S_w
            A = torch.zeros(rows * S_w, dtype=torch.int8, device=device)
            A[flat] = a_v[lo:hi]
            W = torch.zeros(rows * S_w, dtype=torch.bfloat16, device=device)
            W[flat] = w_v[lo:hi]
            rhs_b = rhs.index_select(0, cwin_d[f * batch:(f + 1) * batch])
            return torch.stack(haplotag_score_batch(
                A.view(rows, S_w), W.view(rows, S_w),
                rhs_b.reshape(batch * S_w, K), n_tasks=batch,
                n_blocks=HAPLOTAG_B))

        outs = []
        for f in range(n_launch):
            dispatch.record("haplotag", "device")
            outs.append(devcost.run("haplotag", device, launch, f,
                                    int(bounds[f]), int(bounds[f + 1])))
        hap, pc, best = devcost.get("haplotag", torch.cat(outs, 1))
        read_hap, read_ps, read_pc = tagging
        for k, (i, w) in enumerate(zip(dev, dw)):
            g = slice(ch0[k] * CHUNK, ch0[k] * CHUNK + counts[w])
            present = uk[p0[i]:p0[i] + n_present[i]] % nb
            _scatter_tagged(read_hap, read_pc, read_ps, block_ps, present,
                            order[wstart[w]:wstart[w] + counts[w]], hap[g],
                            pc[g], best[g])
    if host_rows:
        wide = np.union1d(wide, np.concatenate(host_rows))
    _host_score_rows(am, phase, block_id, block_ps, wide, tagging)
    return tagging


def _haplotag_mesh(am: AlleleMatrix, phase: np.ndarray, block_id: np.ndarray,
                   block_ps: np.ndarray, window: int, halo: int, mesh):
    """The dense windows on a device mesh: rows over dp (256 per shard),
    sites over sp, psums on both axes; a window keeps its reads whatever
    its block count, its block table is sized to a power of two, and each
    chunk is one sharded call."""
    from duet_tpu_torch.parallel.mesh import phase_and_tag_sharded
    from duet_tpu_torch.utils import dispatch

    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    chunk = CHUNK * dp
    n, m = am.n_reads, am.n_sites
    tagging = _untagged(n)
    if m == 0 or len(am.row) == 0:
        return tagging
    read_hap, read_ps, read_pc = tagging

    first_col = np.full(n, m, dtype=np.int64)
    last_col = np.full(n, -1, dtype=np.int64)
    np.minimum.at(first_col, am.row, am.col)
    np.maximum.at(last_col, am.row, am.col)
    has_obs = last_col >= 0
    w_of_read = np.where(has_obs, first_col // window, -1)
    span_ok = has_obs & (last_col < (w_of_read + 1) * window + halo)

    S_w = -(-(window + halo) // sp) * sp   # sp-divisible site axis
    w_of_obs = np.where(span_ok[am.row], w_of_read[am.row], -1)
    obs_order = np.argsort(w_of_obs, kind="stable")
    w_sorted = w_of_obs[obs_order]
    for w in range(0, (m + window - 1) // window):
        rows = np.flatnonzero((w_of_read == w) & span_ok)
        if len(rows) == 0:
            continue
        lo = w * window
        hi = min(lo + window + halo, m)
        o0 = int(np.searchsorted(w_sorted, w, "left"))
        o1 = int(np.searchsorted(w_sorted, w, "right"))
        sel = obs_order[o0:o1]
        blk = np.full(S_w, -1, dtype=np.int64)
        blk[: hi - lo] = block_id[lo:hi]
        present = np.unique(blk[blk >= 0])
        row_local = np.searchsorted(rows, am.row[sel])
        col_local = am.col[sel] - lo
        R_pad = max(-(-len(rows) // chunk) * chunk, chunk)
        A = np.zeros((R_pad, S_w), dtype=np.int8)
        Wt = np.zeros((R_pad, S_w), dtype=np.float32)
        A[row_local, col_local] = am.allele[sel]
        Wt[row_local, col_local] = am.weight[sel]
        # each covered site's block, as a column of the window's table
        local_of = {int(b): i for i, b in enumerate(present)}
        ok = np.flatnonzero(blk >= 0)
        block_col = np.array([local_of[int(b)] for b in blk[ok]], np.int64)
        ph = np.zeros(S_w, dtype=np.float32)
        ph[: hi - lo] = phase[lo:hi]
        B = max(8, 1 << (max(len(present), 1) - 1).bit_length())
        onehot = np.zeros((S_w, B), dtype=np.float32)
        onehot[ok, block_col] = 1.0
        for c0 in range(0, len(rows), chunk):
            c1 = min(c0 + chunk, len(rows))
            dispatch.record("haplotag", "mesh")
            hap_d, pc_d, best_d, _ = phase_and_tag_sharded(
                mesh, A[c0:c0 + chunk], Wt[c0:c0 + chunk], ph, onehot,
                sweeps=0)
            _scatter_tagged(read_hap, read_pc, read_ps, block_ps, present,
                            rows[c0:c1],
                            *(x.cpu().numpy()[: c1 - c0]
                              for x in (hap_d, pc_d, best_d)))
    _host_score_rows(am, phase, block_id, block_ps,
                     np.flatnonzero(has_obs & ~span_ok), tagging)
    return tagging


def _pair_products(v: np.ndarray, starts: np.ndarray, seg_k: np.ndarray,
                   k: np.ndarray) -> np.ndarray:
    """L*R at each entry k that has a successor in its read: L the read's
    signed sum of `v` up to and including k, R the rest of the read.
    `starts` holds each read's first entry, `seg_k` the read of each k
    (``snp_phaser_host._spanning_products``' arithmetic)."""
    cum = np.cumsum(v)
    offset = np.concatenate(([0.0], cum[starts[1:] - 1]))
    left = cum[k] - offset[seg_k]
    return left * (np.add.reduceat(v, starts)[seg_k] - left)


class _Block:
    """One phase-set block's observation tables, sorted by (read, local
    site): each entry's local site `lj` and allele x weight `base_v`, each
    read's first entry, the entries `k` with a successor in their read and
    the boundaries [a, b) that the pair spans; and, of the reads that span
    a boundary, their first entry, length and first and last local sites.
    A phase given to its methods is the block's own, indexed by local site."""

    __slots__ = ("cols", "lj", "base_v", "starts", "k", "seg_k", "a", "b",
                 "span_start", "span_len", "span_first", "span_last")

    def __init__(self, cols, rows, lj, base_v):
        self.cols, self.lj, self.base_v = cols, lj, base_v
        new_read = np.ones(len(rows), dtype=bool)
        new_read[1:] = rows[1:] != rows[:-1]
        self.starts = np.flatnonzero(new_read)
        ends = np.append(self.starts[1:], len(rows))
        self.k = np.flatnonzero(~new_read) - 1
        self.seg_k = np.cumsum(new_read)[self.k] - 1
        self.a, self.b = lj[self.k], lj[self.k + 1]
        first, last = lj[self.starts], lj[ends - 1]
        spanning = last > first
        self.span_start = self.starts[spanning]
        self.span_len = (ends - self.starts)[spanning]
        self.span_first, self.span_last = first[spanning], last[spanning]

    def evidence(self, phase: np.ndarray) -> np.ndarray:
        """E_j = sum over reads of L_r(j) * R_r(j) at every boundary j
        (between local sites j and j+1), in full."""
        lr = _pair_products(self.base_v * phase[self.lj], self.starts,
                            self.seg_k, self.k)
        m = len(self.cols)
        return np.cumsum(np.bincount(self.a, lr, m)
                         - np.bincount(self.b, lr, m))[:m - 1]

    def flip(self, phase: np.ndarray, E: np.ndarray, j: int) -> None:
        """Flip the phase of the sites past boundary j, and bring E up to
        date over the boundaries that the reads spanning j span.  A read
        wholly on one side of j keeps its L*R, since both or neither of
        its sums change sign."""
        sel = np.flatnonzero((self.span_first <= j) & (self.span_last > j))
        n = self.span_len[sel]
        ends = np.cumsum(n)
        starts = ends - n
        idx = np.arange(ends[-1]) + np.repeat(self.span_start[sel] - starts,
                                              n)
        seg_k = np.repeat(np.arange(len(sel)), n - 1)
        k = np.arange(len(seg_k)) + seg_k
        lj = self.lj[idx]
        v = self.base_v[idx] * phase[lj]
        delta = (_pair_products(np.where(lj > j, -v, v), starts, seg_k, k)
                 - _pair_products(v, starts, seg_k, k))
        lo, hi = int(lj[starts].min()), int(lj[ends - 1].max())
        d = (np.bincount(lj[k] - lo, delta, hi - lo + 1)
             - np.bincount(lj[k + 1] - lo, delta, hi - lo + 1))
        E[lo:hi] += np.cumsum(d)[:hi - lo]
        phase[j + 1:] *= -1


class SwitchCorrector:
    """``snp_phaser_host._switch_correct`` for one contig, by local updates.

    The blocks' observation tables are built once, since block_id stays
    fixed through the refine-and-correct rounds.  A call takes each
    block's boundary evidence E in full once, then, as the host copy does,
    flips the suffix at argmin E while E has a negative entry, at most
    `max_flips` times a block; after a flip it redoes E only where the
    reads that span the flip lie (``_Block.flip``).  It builds its own
    tables and sums with ``np.bincount``: the host copy's
    ``_block_obs_groups`` and ``_boundary_E`` took about three times as
    long (one Intel Xeon core, a 290,616-nnz contig: 55 ms to build, 18 ms
    a full E).

    Every quantity is an integer (allele x an integral weight).  A read of
    n_r observations, each at most `top` in size, adds at most
    n_r * (n_r * top)^2 to any sum of E, and an update at most twice that,
    so every sum stays below 4 * top^2 * sum over reads of n_r^3.  Below
    2**53 float64 holds each sum exactly in any order, so the phase equals
    the host copy's bit for bit.  A contig with a non-integral weight, or
    a bound that reaches 2**53, takes the host copy (`exact` False)."""

    def __init__(self, am: AlleleMatrix, block_id: np.ndarray) -> None:
        self.am, self.block_id = am, block_id
        self.flips = 0
        self.blocks: list[_Block] = []
        w = am.weight.astype(np.float64)
        self.exact = bool(np.isfinite(w).all() and (np.floor(w) == w).all())
        if not self.exact or len(am.row) == 0:
            return
        n_r = np.bincount(am.row).astype(np.float64)
        top = float(np.abs(w).max() * np.abs(am.allele.astype(float)).max())
        self.exact = 4 * top * top * float(n_r @ (n_r * n_r)) < 2.0 ** 53
        if not self.exact:
            return
        # by (block, read, site): the key read * n_sites + site stays below
        # 2**62, as both are int32
        order = np.argsort(am.row.astype(np.int64) * am.n_sites + am.col,
                           kind="stable")
        order = order[np.argsort(block_id[am.col[order]], kind="stable")]
        rows, cols = am.row[order], am.col[order]
        base_v = am.allele[order].astype(np.float64) * w[order]
        obs_block = block_id[cols]
        site_order = np.argsort(block_id, kind="stable")
        site_block = block_id[site_order]
        local = np.zeros(am.n_sites, dtype=np.int64)
        for b in np.unique(block_id[block_id >= 0]):
            s0, s1 = np.searchsorted(site_block, [b, b + 1])
            o0, o1 = np.searchsorted(obs_block, [b, b + 1])
            if s1 - s0 < 2 or o1 == o0:
                continue
            local[site_order[s0:s1]] = np.arange(s1 - s0)
            self.blocks.append(_Block(site_order[s0:s1], rows[o0:o1],
                                      local[cols[o0:o1]], base_v[o0:o1]))

    def __call__(self, phase: np.ndarray, max_flips: int = 50) -> np.ndarray:
        """The corrected phase; ``flips`` then holds the flips it took."""
        if not self.exact:
            return _switch_correct(self.am, phase, self.block_id, max_flips)
        phase = phase.copy()
        self.flips = 0
        for blk in self.blocks:
            ph = phase[blk.cols]
            E = blk.evidence(ph)
            for _ in range(max_flips):
                j = int(np.argmin(E))
                if E[j] >= 0:
                    break
                blk.flip(ph, E, j)
                self.flips += 1
            phase[blk.cols] = ph
        return phase


def phase_contig_core(cr, snps, cfg=None, sweeps: int = 2,
                      use_device: bool = False, obs=None,
                      min_junction_evidence: float = 0.0,
                      device_min_nnz: int = 0,
                      adaptive_junction_split: bool = False,
                      protect_intervals=None,
                      device: torch.device = _CPU):
    """Mirrors ``duet_tpu.models.snp_phaser.phase_contig_core``:
    (am, phase, block_id, block_ps) for one contig, with the refine sweeps
    on `device` (``ops.sparse_power.power_refine_device``) when use_device
    and the matrix clears `device_min_nnz`.  The switch correction
    (``SwitchCorrector``: its tables, then each round) runs in the span
    ``snp_phasing.switch_correct``; the counters ``snp_phasing.
    correct_rounds``, ``.switch_flips`` and ``.switch_correct_fallbacks``
    (contigs that took the host copy) add up its work."""
    from duet_tpu_torch.ops.sparse_power import (INT32_EXACT_NNZ,
                                                 power_refine_device)

    am = build_allele_matrix(cr, snps, cfg, obs=obs)
    if len(am.row) < device_min_nnz:
        use_device = False
    phase, block_id, block_ps = _initial_phase(am)
    if use_device and len(am.row) <= INT32_EXACT_NNZ:
        def refine(am, phase, block_id, sweeps):
            return power_refine_device(am, phase, block_id, sweeps, device)
    else:
        refine = _power_refine
    # alternate majority refinement and suffix-flip correction to a fixed
    # point
    phase = refine(am, phase, block_id, sweeps)
    with span("snp_phasing.switch_correct"):
        correct = SwitchCorrector(am, block_id)
    count("snp_phasing.switch_correct_fallbacks", int(not correct.exact))
    for _ in range(REFINE_CORRECT_ROUNDS):
        with span("snp_phasing.switch_correct"):
            corrected = correct(phase)
        count("snp_phasing.correct_rounds")
        count("snp_phasing.switch_flips", correct.flips)
        changed = bool(np.any(corrected != phase))
        phase = refine(am, corrected, block_id, sweeps)
        if not changed:
            break
    new_id, new_ps = _split_weak_junctions(
        am, phase, block_id, min_junction_evidence,
        adaptive=adaptive_junction_split, protect=protect_intervals)
    if new_ps is not None:
        block_id, block_ps = new_id, new_ps
    return am, phase, block_id, block_ps


def phase_contig(cr, snps, cfg=None, sweeps: int = 2,
                 use_device: bool = False, obs=None,
                 min_junction_evidence: float = 0.0, mesh=None,
                 device_min_nnz: int = 0,
                 adaptive_junction_split: bool = False,
                 protect_intervals=None,
                 device: torch.device = _CPU,
                 mode: str | None = None) -> PhaseResult:
    """Mirrors ``duet_tpu.models.snp_phaser.phase_contig``: one contig's
    refine and read scoring, both on `device` when use_device and the
    allele matrix clears `device_min_nnz` (the scoring through
    ``_haplotag_device``, one contig at a time; the batch pipeline batches
    it across contigs in ``score_contigs_batched``).  An explicit `mesh`
    is an opt-in that drops the size gate: the refine runs on the mesh's
    first device and the scoring on the mesh.  `mode` picks the device
    scorer (default HAPLOTAG_DEVICE_MODE)."""
    if mesh is not None:
        device_min_nnz = 0
        device = mesh.devices[0][0]
    with span("snp_phasing.refine"):
        am, phase, block_id, block_ps = phase_contig_core(
            cr, snps, cfg, sweeps,
            use_device=use_device, obs=obs,
            min_junction_evidence=min_junction_evidence,
            device_min_nnz=device_min_nnz,
            adaptive_junction_split=adaptive_junction_split,
            protect_intervals=protect_intervals, device=device)
    with span("snp_phasing.score"):
        if use_device and len(am.row) >= device_min_nnz:
            tagging = _haplotag_device(am, phase, block_id, block_ps,
                                       mesh=mesh, mode=mode, device=device)
        else:
            tagging = _haplotag(am, phase, block_id, block_ps)
    return _as_result(am, phase, block_id, block_ps, tagging)


def score_contigs_batched(cores: dict[str, tuple], use_device: bool,
                          device_min_nnz: int,
                          device: torch.device = _CPU,
                          mode: str | None = None
                          ) -> dict[str, PhaseResult]:
    """Final read scoring for many contigs; mirrors
    ``duet_tpu.models.snp_phaser.score_contigs_batched``.

    `cores` maps contig -> (am, phase, block_id, block_ps).  The device
    scores when use_device and the contigs' COMBINED nnz clears
    `device_min_nnz` (several sub-gate contigs cross the gate together); a
    contig past INT32_EXACT_NNZ takes the host scorer.  Under "sparse" (the
    `mode`, default HAPLOTAG_DEVICE_MODE) the contigs go to the COO scorer
    in batches below INT32_EXACT_NNZ; under "dense" each contig goes
    through the windowed route.  Outputs are bit-identical to the host
    scorer either way."""
    from duet_tpu_torch.ops.sparse_power import (
        INT32_EXACT_NNZ,
        haplotag_score_sparse_multi,
    )

    results: dict[str, PhaseResult] = {}
    order = list(cores)
    batch_nnz = sum(len(cores[c][0].row) for c in order)
    if not (use_device and batch_nnz >= device_min_nnz):
        return {c: _as_result(*cores[c], _haplotag(*cores[c]))
                for c in order}
    if (mode or HAPLOTAG_DEVICE_MODE) == "dense":
        for c in order:
            tagging = _haplotag(*cores[c]) \
                if len(cores[c][0].row) > INT32_EXACT_NNZ \
                else _haplotag_device(*cores[c], mode="dense", device=device)
            results[c] = _as_result(*cores[c], tagging)
        return results

    pending: list[str] = []
    pending_nnz = 0

    def flush() -> None:
        nonlocal pending_nnz
        items = []
        for c in pending:
            am, phase, block_id, block_ps = cores[c]
            if am.n_sites == 0 or len(am.row) == 0 or len(block_ps) == 0:
                results[c] = _as_result(*cores[c], _untagged(am.n_reads))
            else:
                items.append(c)
        if items:
            scored = haplotag_score_sparse_multi(
                [(cores[c][0], cores[c][1], cores[c][2]) for c in items],
                device)
            for c, sc in zip(items, scored):
                results[c] = _as_result(*cores[c],
                                        _finish_scored(*cores[c], sc))
        pending.clear()
        pending_nnz = 0

    for c in order:
        nnz = len(cores[c][0].row)
        if nnz > INT32_EXACT_NNZ:
            # past the batch-size bound: the host scorer for this contig
            results[c] = _as_result(*cores[c], _haplotag(*cores[c]))
            continue
        if pending_nnz + nnz > INT32_EXACT_NNZ:
            flush()
        pending.append(c)
        pending_nnz += nnz
    flush()
    return results


def _het_rows(snps: ContigSnps, site_pos: np.ndarray) -> np.ndarray:
    """The row of `snps` of each het site position, by the host copy's map
    of position to row: the last row of a position wins, and a position
    with no het row raises KeyError."""
    het = np.flatnonzero(snps.is_het)
    pos_to_row = dict(zip(snps.pos[het].tolist(), het.tolist()))
    return np.array([pos_to_row[p] for p in site_pos.tolist()], np.int64)


@span("write.phased_snp_vcf")
def write_phased_snp_vcf(path: str, contig: str, snps: ContigSnps,
                         result: PhaseResult, threads: int = 1) -> None:
    """``snp_phaser_host.write_phased_snp_vcf``'s file and .tbi: the het
    sites in phasing order, then the hom sites, put in position order by
    one stable sort, formatted from their columns and indexed from the
    BGZF writer's offsets (deflated on `threads` threads)."""
    header = [
        "##fileformat=VCFv4.2",
        "##source=duet_tpu.snp_phaser",
        f"##contig=<ID={contig}>",
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=PS,Number=1,Type=Integer,Description="Phase set">',
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE",
    ]
    site_pos = np.asarray(result.site_pos, np.int64)
    het = _het_rows(snps, site_pos)
    hom = np.flatnonzero(~snps.is_het)
    sample = np.full(len(site_pos), "0/1:.", dtype=object)
    phased = np.flatnonzero(result.phase != 0)
    sample[phased] = [
        f"{'1|0' if p > 0 else '0|1'}:{ps}" for p, ps in zip(
            result.phase[phased].tolist(),
            result.block_ps[result.block_id[phased]].tolist())]
    pos = np.concatenate([site_pos, snps.pos[hom]])
    order = np.argsort(pos, kind="stable")
    pos = pos[order]
    rows = np.concatenate([het, hom])[order]
    sample = np.concatenate([sample, np.full(len(hom), "1/1:.", object)])
    bases = np.array(list(BASES))
    records = [f"{contig}\t{p}\t.\t{r}\t{a}\t.\tPASS\t.\tGT:PS\t{g}"
               for p, r, a, g in zip(
                   (pos + 1).tolist(), bases[snps.ref_code[rows]].tolist(),
                   bases[snps.alt_code[rows]].tolist(),
                   sample[order].tolist())]
    write_vcf_indexed(path, header, records, [contig],
                      np.zeros(len(pos), np.int64), pos, pos + 1,
                      threads=threads)
