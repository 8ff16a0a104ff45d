"""GPU smoke run of the duet_tpu_torch port: `python3 chip_smoke.py`.

Needs one CUDA card (Hopper, sm_90a) and nvcc; builds the port's CUDA
kernels from the sources in this checkout (one nvcc per source, started
together).  Phases, each printing one line:

  [card]        the card (name and power limit from nvidia-smi), torch/CUDA
                versions, the kernel build times and ptxas's registers,
                spills and shared memory for every kernel instantiation;
  [kernel]      the batched scoring kernel against its plain torch version
                at the pipeline's launch shape and on edge cases;
  [batched K=256]  the same kernel with rhs wider than 128 columns;
  [score edges] both score entries (batched and precomputed aw) on every
                K in 3, 9, 66, 72, 130, 256 by S in 777, 1000, 1040, 2304
                and rows in 1, 100, 1000, with all-zero rows, tied blocks
                and negative signed sums;
  [sweep]       the power-iteration sweep kernel against its plain version
                at the bench shape and on SWEEP_EDGE_SHAPES (both arms,
                every tile boundary), with sweep_launch_shape for each;
  [fused]       phase_and_tag_fused on the kernels against the plain
                phase_and_tag (bench shape, sweeps 0/2/3, B=200), and the
                shared-rhs score launch alone;
  [score_pre]   haplotag_score (the precomputed-aw kernel) as a user calls
                it, then against its plain version;
  [nn]          the neural SNP caller's forward pass on the card vs the CPU;
  [sim]         a simulated dataset (2 contigs x 5 Mb, 20x, fixed seed);
  [pipeline on] the batch pipeline through the port's CLI with
                --device-stages on (dense scorer), every stage on the device;
  [pipeline off]  the same CLI with --device-stages off: byte-identical;
  [pipeline sparse]  --device-stages on with the sparse COO scorer:
                byte-identical to both;
  [bench]       `python -m duet_tpu_torch.bench`'s full run in process.

Every comparison of a kernel with its plain version is exact (torch.equal).
Times are medians of CUDA-event timed launches taken in turns (plain,
kernel, kernel, plain); beside each kernel stand its bound (the larger of
its bytes over the card's memory rate and its operations over the peak
rate for their type) and one PyTorch library call on the same inputs (a
float32 cuBLAS product; the port never calls it).
Each path (the pipeline on, haplotag_score, the bench) runs with the launch
counts set to 0 just before it and read just after, and fails if a kernel
of that path never launched.  Any failure exits non-zero.  The
second-to-last line is one JSON object describing the kernels; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import gzip
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

TOLERANCE = "exact (torch.equal on int32 hap/pc/best)"
# an H100 SXM's published peaks (HBM3 bandwidth, dense tensor/FP32 rates)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}


def _median_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _turns(kernel, plain, rounds: int = 3, reps: int = 20):
    """(kernel ms, plain ms): medians over `rounds` turns of (plain, kernel,
    kernel, plain), each turn the median of `reps` launches."""
    ks, ps = [], []
    for _ in range(rounds):
        ps.append(_median_ms(plain, reps))
        ks.append(_median_ms(kernel, reps))
        ks.append(_median_ms(kernel, reps))
        ps.append(_median_ms(plain, reps))
    return float(np.median(ks)), float(np.median(ps))


def _bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: bytes moved once over the memory
    rate against the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def score_bound(rows: int, S: int, K: int, n_tasks: int, lhs_bytes: int):
    """A score launch: the lhs (`lhs_bytes` a cell: 3 for int8 alleles +
    bf16 weights, 4 for aw + |aw|), each task's bf16 rhs and three int32
    outputs a row, once each; 2 * rows * S * K bf16 products."""
    return _bound(rows * S * lhs_bytes + n_tasks * S * K * 2 + 3 * rows * 4,
                  2.0 * rows * S * K, "bf16")


def pipeline_shaped_inputs(seed: int, n_tasks: int = 16, rows: int = 256,
                           S: int = 2304, K: int = 128, n_blocks: int = 126):
    """Chunks shaped like the pipeline's: position-sorted reads covering
    short runs of het sites, alleles +-1, integer weights <= 40, phase
    +-1 with some unphased sites, and a one-hot table of contiguous
    phase-set blocks."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n_tasks * rows, S), np.int8)
    W = np.zeros((n_tasks * rows, S), np.float32)
    rhs = np.zeros((n_tasks * S, K), np.float32)
    for t in range(n_tasks):
        starts = np.sort(rng.integers(0, S, rows))
        spans = rng.integers(5, 80, rows)
        for r in range(rows):
            lo, hi = starts[r], min(starts[r] + spans[r], S)
            cov = rng.random(hi - lo) < 0.9
            cols = np.arange(lo, hi)[cov]
            A[t * rows + r, cols] = rng.choice([-1, 1], len(cols))
            W[t * rows + r, cols] = rng.integers(1, 41, len(cols))
        phase = rng.choice([-1.0, 1.0], S) * (rng.random(S) > 0.05)
        nb = int(rng.integers(1, n_blocks + 1))
        cuts = np.sort(rng.choice(np.arange(1, S), nb - 1, replace=False))
        block = np.searchsorted(cuts, np.arange(S), side="right")
        block[rng.random(S) < 0.02] = -1          # sites outside any block
        blk = rhs[t * S:(t + 1) * S]
        blk[:, 0] = phase
        blk[:, 1] = phase != 0
        ok = block >= 0
        blk[np.flatnonzero(ok), 2 + block[ok]] = 1.0
    return A, W, rhs


def score_edge_inputs(seed: int, T: int, rows: int, S: int, K: int):
    """Pipeline-shaped chunks with, in each task as far as its rows go: an
    all-zero row, a row whose sites are all unphased, a row whose weight
    ties two blocks (when K leaves room for blocks 4 and 9) and a row
    flipped to a negative signed sum."""
    A, W, rhs = pipeline_shaped_inputs(seed, T, rows, S, K, K - 2)
    rng = np.random.default_rng(seed + 1)
    lo, tie = S // 2, S // 2 + 100
    for t in range(T):
        base = t * rows
        A[base + 0] = 0                            # total 0
        W[base + 0] = 0
        blk = rhs[t * S:(t + 1) * S]
        blk[lo:lo + 20, 0] = 0                     # unphased sites
        blk[lo:lo + 20, 1] = 0
        if rows > 1:
            A[base + 1] = 0
            A[base + 1, lo:lo + 20] = 1
            W[base + 1, lo:lo + 20] = 7
        if rows > 2 and K - 2 > 9:
            # tie: two blocks with the same summed weight on one read
            blk[tie:tie + 10, 2:] = 0
            blk[tie:tie + 5, 2 + 4] = 1
            blk[tie + 5:tie + 10, 2 + 9] = 1
            A[base + 2] = 0
            A[base + 2, tie:tie + 10] = rng.choice([-1, 1], 10)
            W[base + 2, tie:tie + 10] = 20
        if rows > 3:
            A[base + 3] = -A[base + 3]             # flip to negative signed
    return A, W, rhs


def edge_case_inputs(seed: int):
    """Small odd shapes: S and rows off the tile sizes, K < 128, tied
    block weights, all-zero rows, rows whose sites are all unphased."""
    T, K = 3, 40
    return (*score_edge_inputs(seed, T, 100, 1000, K), T, K - 2)


# (K, S, rows) of [score edges]: K below, at and above one n8 tile, one
# 128-column slab and two; S off the 16-byte copy (777, 1000: element-wise
# staging) and off the 64-site stage with whole copies (1040); rows off the
# 64- and 128-row tiles
SCORE_EDGE_SHAPES = [(K, S, rows) for K in (3, 9, 66, 72, 130, 256)
                     for S, rows in ((777, 100), (1000, 1000), (2304, 1),
                                     (1040, 100))]


def bench_inputs(B: int = 64, seed: int = 0):
    """bench.py's kernel batch at its full shape (R=32768, S=4096)."""
    from duet_tpu_torch.bench import KERNEL_SHAPE, make_batch

    R, S, _ = KERNEL_SHAPE["full"]
    return make_batch(R, S, B, density=0.05, seed=seed)


def sweep_edge_inputs(seed: int):
    """R and S off every tile size, 70 all-zero rows, zero-phase sites."""
    from duet_tpu_torch.bench import make_batch

    A, W, phase0, onehot = make_batch(1000, 777, 5, density=0.2, seed=seed)
    A[:70] = 0
    W[:70] = 0
    phase0[::9] = 0
    return A, W, phase0, onehot


# The sweep kernel's one-pass arm: the most rows a tile, and the longest
# row it holds on an H100 (232,448 bytes of shared memory a block: a ring
# of two 1-row tiles, 6 S, the phase and vote partials, 6 S, and 544
# bytes); longer rows take the rereading arm (csrc/haplotag_sweep.cu)
SWEEP_ROWS = 8
SWEEP_ROW_LIMIT = 19_312

# (R, S, kind) of the sweep's edge shapes: R at 1, a tile's rows - 1 and
# + 1, and 1000; S at 1, 15 (off the 16-byte copies), 777, 4096 (the
# bench's) and 3 past the one-CTA row limit (the rereading arm); then the
# limit itself (1-row tiles), 4352 (4-row tiles), a window whose every row
# sum is 0, and R = 400,000 x S = 64, the plain version's exactness edge.
# "mixed": density 0.2 with every 5th row (from row 2) all zero and every
# 9th site (from site 4) unphased; "cancel": every row sum 0, so h = 0 and
# the votes are all 0; "deep": every site covered, votes near 2^24.
SWEEP_EDGE_SHAPES = [(R, S, "mixed") for R in (1, SWEEP_ROWS - 1,
                                               SWEEP_ROWS + 1, 1000)
                     for S in (1, 15, 777, 4096, SWEEP_ROW_LIMIT + 3)] + [
    (SWEEP_ROWS + 1, SWEEP_ROW_LIMIT, "mixed"), (1000, 4352, "mixed"),
    (300, 512, "cancel"), (400_000, 64, "deep")]


def sweep_edge_batch(R: int, S: int, kind: str):
    """(alleles int8, weights float32, phase float32) of one edge shape,
    from a seed made of the shape; weights are integers <= 40."""
    rng = np.random.default_rng([R, S, len(kind)])
    phase = rng.choice(np.array([-1.0, 1.0], np.float32), S)
    if kind == "deep":
        A = np.where(rng.random((R, S)) < 0.97, 1, -1).astype(np.int8)
        W = rng.integers(36, 41, (R, S)).astype(np.float32)
        return A, W, np.ones(S, np.float32)
    if kind == "cancel":
        # sites in pairs (2k, 2k+1) with one weight, alleles chosen so the
        # pair's aw * phase sum to 0; every row sum is then 0
        cov = rng.random((R, S // 2)) < 0.3
        a0 = np.where(cov, rng.choice([-1, 1], (R, S // 2)), 0)
        w = np.where(cov, rng.integers(1, 41, (R, S // 2)), 0)
        A = np.zeros((R, S), np.int8)
        W = np.zeros((R, S), np.float32)
        A[:, 0::2], A[:, 1::2] = a0, -a0 * phase[0::2] * phase[1::2]
        W[:, 0::2] = W[:, 1::2] = w
        return A, W, phase
    cov = rng.random((R, S)) < 0.2
    A = np.where(cov, rng.choice([-1, 1], (R, S)), 0).astype(np.int8)
    W = np.where(cov, rng.integers(1, 41, (R, S)), 0).astype(np.float32)
    A[2::5] = 0
    W[2::5] = 0
    phase[4::9] = 0
    return A, W, phase


def _cuda(A, W, phase0, onehot):
    """Card tensors: alleles int8, weights float32 and bf16, phase, onehot."""
    import torch

    a, w, p, oh = (torch.from_numpy(x).cuda() for x in (A, W, phase0, onehot))
    return a, w, w.to(torch.bfloat16), p, oh


def _max_abs_err(got, want) -> int:
    return max(int((g.long() - x.long()).abs().max()) if g.numel() else 0
               for g, x in zip(got, want))


def _require_equal(got, want, names, what: str) -> None:
    import torch

    torch.cuda.synchronize()
    for name, g, x in zip(names, got, want):
        if not torch.equal(g, x):
            raise AssertionError(f"{what}: kernel != plain on {name}")


def _require_launches(counts: dict, names, path: str) -> None:
    missing = [n for n in names if counts[n] < 1]
    if missing:
        raise AssertionError(f"{path} never launched {missing}: {counts}")


def _kernel_name(mangled: str) -> str:
    """A kernel instantiation named by its template arguments."""
    import re

    v = re.search(r"(FusedAw|GivenAw)E(?:Li(\d+)ELi(\d+)E)?", mangled)
    if v:
        return f"score<{v.group(1)}>" if not v.group(2) else \
            f"score<{v.group(1)}, {v.group(2)} warps, {v.group(3)} stages>"
    v = re.search(r"sweep_one_passILi(\d+)ELi(\d+)ELi(\d+)E", mangled)
    if v:
        return f"sweep one-pass<{v.group(1)} threads, {v.group(2)} rows, " \
               f"{v.group(3)} stages>"
    return "sweep reread" if "sweep_reread" in mangled else mangled


def ptxas_info(log: str) -> list[str]:
    """One line per kernel instantiation from nvcc's -Xptxas -v output:
    its name (score kernels: lhs variant, warps, stages; the sweep's
    one-pass arm: threads, rows, stages), registers, spills, stack and
    static shared memory.  The rings are dynamic shared memory, printed
    per launch by the phases."""
    import re

    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = _kernel_name(m.group(1))
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            out.append(f"{name}: {ln.split('info    :')[-1].strip()}, "
                       f"{spill}")
            name, spill = None, ""
    return out


def phase_card(report: dict) -> None:
    import torch

    from duet_tpu_torch.device import resolve
    from duet_tpu_torch.ops import cuda_build, haplotag_kernel

    resolve("cuda")      # TF32 off for the plain versions' float32 products
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    report["card"] = smi.stdout.strip().splitlines()[0]
    t = time.perf_counter()
    haplotag_kernel.build()
    wall = time.perf_counter() - t
    builds = ", ".join(
        f"{n} {cuda_build.BUILD_INFO[n]['seconds']} s (fresh build: "
        f"{cuda_build.BUILD_INFO[n]['built']})"
        for n in ("haplotag_score", "haplotag_sweep"))
    report["ptxas"] = ptxas = [
        info for n in ("haplotag_score", "haplotag_sweep")
        for info in ptxas_info(cuda_build.BUILD_INFO[n]["log"])]
    print(f"[card] {report['card']} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | kernels built in parallel in {wall:.1f} s: "
          f"{builds} | ptxas -v: {' ; '.join(ptxas)}", flush=True)


def _on_card(A, W, rhs):
    import torch

    return (torch.from_numpy(A).cuda(),
            torch.from_numpy(W).to(torch.bfloat16).cuda(),
            torch.from_numpy(rhs).to(torch.bfloat16).cuda())


def _shape_note(shape: dict) -> str:
    return (f"{shape['warps']} warps x {shape['stages']} stages, "
            f"{shape['smem_bytes']} B dynamic smem")


def phase_kernel(report: dict) -> None:
    import torch

    from duet_tpu_torch.ops.haplotag import _aw, phase_and_tag_batch
    from duet_tpu_torch.ops.haplotag_kernel import (haplotag_score_batch,
                                                    score_launch_shape)

    T, rows, S, K, nb = 16, 256, 2304, 128, 126
    A, W, rhs = pipeline_shaped_inputs(seed=2024)
    a, w, r = _on_card(A, W, rhs)
    got = haplotag_score_batch(a, w, r, T, nb)
    want = phase_and_tag_batch(a, w, r, T, nb)
    _require_equal(got, want, ("hap", "pc", "best"), "pipeline shape")
    worst = _max_abs_err(got, want)
    tagged = float((got[0] != 0).float().mean())
    ms, plain_ms = _turns(lambda: haplotag_score_batch(a, w, r, T, nb),
                          lambda: phase_and_tag_batch(a, w, r, T, nb))
    aw32 = _aw(a, w).reshape(T, rows, S)
    rhs32 = r.float().reshape(T, S, K)
    library_ms = _median_ms(lambda: torch.bmm(aw32, rhs32))
    for seed in (1, 2, 3):
        A, W, rhs, T2, nb2 = edge_case_inputs(seed)
        a2, w2, r2 = _on_card(A, W, rhs)
        _require_equal(haplotag_score_batch(a2, w2, r2, T2, nb2),
                       phase_and_tag_batch(a2, w2, r2, T2, nb2),
                       ("hap", "pc", "best"), f"edge case seed {seed}")
    shape = score_launch_shape(T, rows, K, True)
    report["kernel"] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": worst,
                        "library_ms": library_ms,
                        **score_bound(T * rows, S, K, T, 3)}
    print(f"[kernel] haplotag_score == plain ({TOLERANCE}) at T={T} x "
          f"{rows} rows, S={S}, K={K}, n_blocks={nb} ({tagged:.3f} rows "
          f"tagged) and on 3 edge-case sets; launch {_shape_note(shape)}; "
          f"median {ms:.4f} ms vs plain {plain_ms:.4f} ms vs library "
          f"(float32 bmm of a prebuilt aw) {library_ms:.4f} ms, bound "
          f"{report['kernel']['bound_ms']:.4f} ms "
          f"({report['kernel']['bound_by']}) on {report['card']}",
          flush=True)

    # rhs wider than one 128-column slab: K = 256 at the pipeline shape,
    # and K = 130 (two columns into the second slab) off the tile sizes
    parts = []
    for seed, T, rows, S, K in ((5, 16, 256, 2304, 256), (6, 3, 100, 1000, 130)):
        A, W, rhs = pipeline_shaped_inputs(seed, T, rows, S, K, K - 2)
        a, w, r = _on_card(A, W, rhs)
        got = haplotag_score_batch(a, w, r, T, K - 2)
        _require_equal(got, phase_and_tag_batch(a, w, r, T, K - 2),
                       ("hap", "pc", "best"), f"K={K}")
        parts.append(f"T={T} x {rows} rows, S={S}, K={K} (best block up to "
                     f"{int(got[2].max())})")
    print(f"[batched K=256] haplotag_score == plain ({TOLERANCE}) at "
          f"{' and '.join(parts)}", flush=True)


def phase_score_edges(report: dict) -> None:
    """Both score entries on SCORE_EDGE_SHAPES: the batched one (3 tasks)
    and the precomputed-aw one (task 0's rows and rhs)."""
    import torch

    from duet_tpu_torch.ops.haplotag import (haplotag_score_plain,
                                             phase_and_tag_batch)
    from duet_tpu_torch.ops.haplotag_kernel import (haplotag_score_batch,
                                                    haplotag_score_pre)

    T = 3
    for K, S, rows in SCORE_EDGE_SHAPES:
        a, w, r = _on_card(*score_edge_inputs(K + S + rows, T, rows, S, K))
        what = f"K={K} S={S} rows={rows}"
        _require_equal(haplotag_score_batch(a, w, r, T, K - 2),
                       phase_and_tag_batch(a, w, r, T, K - 2),
                       ("hap", "pc", "best"), f"batched {what}")
        aw = a[:rows].to(torch.bfloat16) * w[:rows]
        abs_aw = aw.abs()
        r0 = r[:S].contiguous()
        _require_equal(haplotag_score_pre(aw, abs_aw, r0, K - 2),
                       haplotag_score_plain(aw, abs_aw, r0, K - 2),
                       ("hap", "pc", "best"), f"precomputed aw {what}")
    print(f"[score edges] batched and precomputed-aw score kernels == plain "
          f"({TOLERANCE}) on {len(SCORE_EDGE_SHAPES)} shapes (K x S x rows: "
          f"{', '.join(f'{k}x{s}x{n}' for k, s, n in SCORE_EDGE_SHAPES)})",
          flush=True)


def _sweep_note(shape: dict) -> str:
    return (f"{shape['arm']}, {shape['rows']} rows x {shape['stages']} "
            f"stages, {shape['ctas']} CTAs ({shape['ctas_per_sm']}/SM), "
            f"cluster {shape['cluster']}, {shape['smem_bytes']} B dynamic "
            f"smem, {shape['copy']} copies")


def phase_sweep(report: dict) -> None:
    """The sweep kernel against its plain version at the bench shape and on
    SWEEP_EDGE_SHAPES, with the launch shape of each."""
    import torch

    from duet_tpu_torch.bench import KERNEL_SHAPE
    from duet_tpu_torch.ops.haplotag import _aw, power_sweep_votes
    from duet_tpu_torch.ops.haplotag_kernel import (power_sweep,
                                                    sweep_launch_shape)

    # the arm the bench and quick shapes take reads the window once
    for label in ("full", "quick"):
        R, S, _ = KERNEL_SHAPE[label]
        shape = sweep_launch_shape(R, S)
        if shape["arm"] != "one_pass" or shape["rows"] != SWEEP_ROWS or \
                shape["copy"] == "element":
            raise AssertionError(f"sweep at the {label} shape: {shape}")
    for S, arm in ((SWEEP_ROW_LIMIT, "one_pass"),
                   (SWEEP_ROW_LIMIT + 1, "reread")):
        if sweep_launch_shape(1, S)["arm"] != arm:
            raise AssertionError(f"sweep at S={S} is not {arm}: the "
                                 f"one-CTA row limit moved")

    a, _, w16, p, _ = _cuda(*bench_inputs())
    p16 = p.to(torch.bfloat16)
    got = power_sweep(a, w16, p16)
    want = power_sweep_votes(a, w16, p16)
    _require_equal([got], [want], ["votes"], "sweep, bench")
    ms, plain_ms = _turns(lambda: power_sweep(a, w16, p16),
                          lambda: power_sweep_votes(a, w16, p16))
    aw32, p32 = _aw(a, w16), p16.float()
    library_ms = _median_ms(lambda: aw32.T @ torch.sign(aw32 @ p32))
    del aw32
    R, S = a.shape
    bench = f"R={R} S={S} ({_sweep_note(sweep_launch_shape(R, S))})"
    # alleles + weights once, the phase in and the votes out; two
    # multiply-adds an element (h, then the votes) on CUDA cores
    report["sweep"] = {"ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms,
                       "max_abs_err": float((got - want).abs().max()),
                       **_bound(R * S * 3 + S * 2 + S * 4, 4.0 * R * S,
                                "fp32")}
    edges = []
    for R, S, kind in SWEEP_EDGE_SHAPES:
        A, W, phase = sweep_edge_batch(R, S, kind)
        a = torch.from_numpy(A).cuda()
        w16 = torch.from_numpy(W).to(torch.bfloat16).cuda()
        p16 = torch.from_numpy(phase).to(torch.bfloat16).cuda()
        got = power_sweep(a, w16, p16)
        _require_equal([got], [power_sweep_votes(a, w16, p16)], ["votes"],
                       f"sweep, {R} x {S} {kind}")
        if kind == "cancel" and bool(got.any()):
            raise AssertionError("sweep: votes of a window of zero row sums")
        edges.append(f"{R}x{S} {kind} ({_sweep_note(sweep_launch_shape(R, S))}"
                     f"; |votes| up to {int(got.abs().max())})")
    sw = report["sweep"]
    print(f"[sweep] haplotag_sweep == power_sweep_votes (torch.equal on "
          f"float32 votes) at the bench shape {bench}: median {ms:.4f} ms "
          f"vs plain {plain_ms:.4f} ms vs library (two float32 gemvs on a "
          f"prebuilt aw) {library_ms:.4f} ms, bound {sw['bound_ms']:.4f} ms "
          f"({sw['bound_by']}) on {report['card']}; and on "
          f"{len(SWEEP_EDGE_SHAPES)} edge shapes: {'; '.join(edges)}",
          flush=True)


def phase_fused(report: dict) -> None:
    from duet_tpu_torch.ops import haplotag_kernel
    from duet_tpu_torch.ops.haplotag import (_aw, phase_and_tag,
                                             phase_and_tag_batch)

    keys = ("hap", "pc", "best_block", "phase")
    parts = []
    for B, sweeps in ((64, 2), (64, 0), (64, 3), (200, 2)):
        a, w, w16, p, oh = _cuda(*bench_inputs(B))
        got = haplotag_kernel.phase_and_tag_fused(a, w16, p, oh, sweeps)
        want = phase_and_tag(a, w, p, oh, sweeps)
        _require_equal([got[k] for k in keys], [want[k] for k in keys], keys,
                       f"fused B={B} sweeps={sweeps}")
        if (B, sweeps) != (64, 2):
            parts.append(f"B={B} sweeps={sweeps} (best block up to "
                         f"{int(got['best_block'].max())})")
            continue
        ms, plain_ms = _turns(
            lambda: haplotag_kernel.phase_and_tag_fused(a, w16, p, oh, 2),
            lambda: phase_and_tag(a, w, p, oh, 2), reps=10)
        report["fused"] = {"ms": ms, "plain_ms": plain_ms}
        parts.append(f"B={B} sweeps={sweeps}: {ms:.4f} ms vs plain "
                     f"{plain_ms:.4f} ms")
        # the shared-rhs score launch alone, on the refined phase
        rhs = haplotag_kernel._rhs(got["phase"], oh)
        shared = haplotag_kernel._score_batch(
            "haplotag_score_shared", a, w16, rhs, 1, B)
        plain = phase_and_tag_batch(a, w16, rhs, 1, B)
        _require_equal(shared, plain, ("hap", "pc", "best"),
                       "shared-rhs score launch")
        ms, plain_ms = _turns(
            lambda: haplotag_kernel._score_batch(
                "haplotag_score_shared", a, w16, rhs, 1, B),
            lambda: phase_and_tag_batch(a, w16, rhs, 1, B))
        aw32, rhs32 = _aw(a, w16), rhs.float()
        R, S = a.shape
        report["shared"] = {
            "max_abs_err": _max_abs_err(shared, plain), "ms": ms,
            "plain_ms": plain_ms,
            "library_ms": _median_ms(lambda: aw32 @ rhs32),
            "shape": haplotag_kernel.score_launch_shape(1, R, rhs.shape[1],
                                                        True),
            **score_bound(R, S, rhs.shape[1], 1, 3)}
    sh = report["shared"]
    print(f"[fused] phase_and_tag_fused == phase_and_tag ({TOLERANCE} and "
          f"int8 phase) at R={a.shape[0]}, S={a.shape[1]}; median "
          f"{'; '.join(parts)}; the shared-rhs score launch alone "
          f"({_shape_note(sh['shape'])}) {sh['ms']:.4f} ms vs plain "
          f"{sh['plain_ms']:.4f} ms vs library (float32 aw @ rhs, prebuilt "
          f"aw) {sh['library_ms']:.4f} ms, bound {sh['bound_ms']:.4f} ms "
          f"({sh['bound_by']})", flush=True)


def phase_score_pre(report: dict) -> None:
    import torch

    from duet_tpu_torch.ops import haplotag_kernel
    from duet_tpu_torch.ops.haplotag import haplotag_score_plain

    parts = []
    for B in (64, 200):
        a, w, _, p, oh = _cuda(*bench_inputs(B))
        if B == 64:     # the path: haplotag_score as a user calls it
            torch.cuda.synchronize()
            haplotag_kernel.reset_launches()
            got = haplotag_kernel.haplotag_score(a, w, p, oh)
            torch.cuda.synchronize()
            counts = dict(haplotag_kernel.LAUNCHES)
            _require_launches(counts, ["haplotag_score_pre"],
                              "haplotag_score")
            report["launches_score_pre"] = counts["haplotag_score_pre"]
        else:
            got = haplotag_kernel.haplotag_score(a, w, p, oh)
        aw = a.to(torch.bfloat16) * w.to(torch.bfloat16)
        abs_aw = aw.abs()
        rhs = haplotag_kernel._rhs(p, oh)
        want = haplotag_score_plain(aw, abs_aw, rhs, B)
        _require_equal(got, want, ("hap", "pc", "best"), f"score_pre B={B}")
        if B != 64:
            parts.append(f"B={B}")
            continue
        ms, plain_ms = _turns(
            lambda: haplotag_kernel.haplotag_score_pre(aw, abs_aw, rhs, B),
            lambda: haplotag_score_plain(aw, abs_aw, rhs, B))
        aw32, rhs32 = aw.float(), rhs.float()
        R, S = aw.shape
        report["score_pre"] = {
            "ms": ms, "plain_ms": plain_ms,
            "max_abs_err": _max_abs_err(got, want),
            "library_ms": _median_ms(lambda: aw32 @ rhs32),
            "shape": haplotag_kernel.score_launch_shape(1, R, rhs.shape[1],
                                                        False),
            **score_bound(R, S, rhs.shape[1], 1, 4)}
        sp = report["score_pre"]
        parts.append(f"B={B} ({_shape_note(sp['shape'])}): {ms:.4f} ms vs "
                     f"plain {plain_ms:.4f} ms vs library (float32 aw @ rhs) "
                     f"{sp['library_ms']:.4f} ms, bound {sp['bound_ms']:.4f} "
                     f"ms ({sp['bound_by']})")
    print(f"[score_pre] haplotag_score == haplotag_score_plain ({TOLERANCE}) "
          f"at R={a.shape[0]}, S={a.shape[1]}; the kernel on the given aw, "
          f"median {'; '.join(parts)}; launches in the path "
          f"{report['launches_score_pre']}", flush=True)


def phase_nn(report: dict) -> None:
    import torch

    from duet_tpu_torch.models.nn_snp import N_FEATURES, load_model

    x = np.random.default_rng(7).random((8192, N_FEATURES), np.float32)
    with torch.no_grad():
        gpu = load_model(device=torch.device("cuda"))(
            torch.from_numpy(x).cuda()).cpu()
        cpu = load_model()(torch.from_numpy(x))
    if not torch.equal(gpu.argmax(1), cpu.argmax(1)):
        raise AssertionError("SnpMLP argmax differs between card and CPU")
    diff = float((gpu - cpu).abs().max())
    print(f"[nn] SnpMLP forward on the card == CPU argmax on 8192 rows "
          f"(max |logit diff| {diff:.3e}, float32, TF32 off)", flush=True)


def phase_simulate(report: dict, work: str) -> str:
    from duet_tpu_torch.sim import SimConfig, simulate_dataset

    t = time.perf_counter()
    data = os.path.join(work, "data")
    simulate_dataset(data, SimConfig(
        contigs={"chr1": 5_000_000, "chr2": 5_000_000}, coverage=20.0,
        seed=11))
    print(f"[sim] 2 contigs x 5 Mb at 20x (seed 11) in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return data


def _run_cli(data: str, out: str, mode: str) -> dict:
    from duet_tpu_torch.cli import main as cli_main

    rc = cli_main([os.path.join(data, "reads.bam"),
                   os.path.join(data, "ref.fa"), out,
                   "--device-stages", mode])
    if rc != 0:
        raise AssertionError(f"duet-tpu-torch --device-stages {mode} "
                             f"exited {rc}")
    with open(os.path.join(out, "metrics.json")) as f:
        return json.load(f)


def phase_pipeline_on(report: dict, data: str, work: str) -> None:
    import torch

    from duet_tpu_torch.ops import haplotag_kernel

    torch.cuda.synchronize()
    haplotag_kernel.reset_launches()
    metrics = _run_cli(data, os.path.join(work, "on"), "on")
    counts = dict(haplotag_kernel.LAUNCHES)
    report["launches"] = counts["haplotag_score"]
    backends = metrics["backends"]
    wrong = {s: b for s, b in backends.items() if b != "device"}
    if wrong:
        raise AssertionError(f"stages not on the device: {wrong}")
    _require_launches(counts, ["haplotag_score"], "the pipeline (dense)")
    report["pipeline_on"] = metrics
    print(f"[pipeline on] backends all device, haplotag_score launches "
          f"{report['launches']}, ingest {metrics['ingest']['backend']}, "
          f"reads {metrics['counts']['reads']}, snp sites "
          f"{metrics['counts']['snp_sites']}, tagged reads "
          f"{metrics['counts']['tagged_reads']}, total "
          f"{metrics['total_s']} s, stages {json.dumps(metrics['stages'])}, "
          f"device_cost {json.dumps(metrics['device_cost'])}", flush=True)


def _read(path: str) -> bytes:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _compare_artifacts(a: str, b: str) -> int:
    """Assert the two runs' artifacts are byte-identical; returns how many."""
    if sorted(os.listdir(os.path.join(a, "snp_phasing"))) != \
            sorted(os.listdir(os.path.join(b, "snp_phasing"))):
        raise AssertionError(f"snp_phasing/ holds different files in {a} "
                             f"and {b}")
    names = ["snp_calling/pileup.vcf.gz", "sv_calling/variants.vcf",
             "phased_sv.vcf"]
    names += [f"snp_phasing/{n}"
              for n in sorted(os.listdir(os.path.join(a, "snp_phasing")))]
    for name in names:
        if _read(os.path.join(a, name)) != _read(os.path.join(b, name)):
            raise AssertionError(f"{name} differs between {a} and {b}")
    return len(names)


def phase_pipeline_off(report: dict, data: str, work: str) -> None:
    from duet_tpu_torch.ops import haplotag_kernel

    before = dict(haplotag_kernel.LAUNCHES)
    metrics = _run_cli(data, os.path.join(work, "off"), "off")
    if haplotag_kernel.LAUNCHES != before:
        raise AssertionError("--device-stages off launched a kernel")
    on = os.path.join(work, "on")
    n = _compare_artifacts(on, os.path.join(work, "off"))
    with open(os.path.join(on, "phased_sv.vcf")) as f:
        n_phased = sum(1 for ln in f if ln.strip() and not ln.startswith("#"))
    if n_phased == 0:
        raise AssertionError("the run phased no SV call")
    print(f"[pipeline off] {n} artifacts byte-identical to the "
          f"device run ({n_phased} phased SV calls); host total "
          f"{metrics['total_s']} s, stages {json.dumps(metrics['stages'])}",
          flush=True)


def phase_pipeline_sparse(report: dict, data: str, work: str) -> None:
    """--device-stages on with duet_tpu's default scorer, the sparse COO
    scatter: the same artifacts, and its haplotag cost beside the dense
    kernel's."""
    from duet_tpu_torch.models import snp_phaser
    from duet_tpu_torch.ops import haplotag_kernel

    before = dict(haplotag_kernel.LAUNCHES)
    snp_phaser.HAPLOTAG_DEVICE_MODE = "sparse"
    try:
        metrics = _run_cli(data, os.path.join(work, "sparse"), "on")
    finally:
        snp_phaser.HAPLOTAG_DEVICE_MODE = "dense"
    if haplotag_kernel.LAUNCHES != before:
        raise AssertionError("the sparse scorer launched a dense kernel")
    if metrics["backends"]["haplotag"] != "device":
        raise AssertionError(f"sparse haplotag ran on "
                             f"{metrics['backends']['haplotag']}")
    sparse = os.path.join(work, "sparse")
    n = _compare_artifacts(sparse, os.path.join(work, "on"))
    _compare_artifacts(sparse, os.path.join(work, "off"))
    dense = report["pipeline_on"]
    report["pipeline_sparse"] = metrics
    print(f"[pipeline sparse] {n} artifacts byte-identical to the dense on "
          f"run and to off; haplotag device_cost sparse "
          f"{json.dumps(metrics['device_cost']['haplotag'])} vs dense "
          f"{json.dumps(dense['device_cost']['haplotag'])}; snp_phasing "
          f"stage {metrics['stages']['snp_phasing']} s vs dense "
          f"{dense['stages']['snp_phasing']} s; total {metrics['total_s']} s "
          f"vs dense {dense['total_s']} s; stages "
          f"{json.dumps(metrics['stages'])}", flush=True)


def phase_bench(report: dict) -> None:
    """`python -m duet_tpu_torch.bench` (kernel + e2e auto + e2e on), in
    process; it must go through the fused kernels and print one JSON
    line, last."""
    import torch

    from duet_tpu_torch import bench
    from duet_tpu_torch.ops import haplotag_kernel

    torch.cuda.synchronize()
    haplotag_kernel.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main([])
    counts = dict(haplotag_kernel.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"the bench exited {rc}")
    _require_launches(counts, ["haplotag_sweep", "haplotag_score_shared",
                               "haplotag_score"], "the bench")
    line = out.getvalue().strip().splitlines()[-1]
    result = json.loads(line)
    if result["e2e_forced_device"]["backends"]["haplotag"] != "device":
        raise AssertionError("the bench's forced-device run scored on host")
    report["bench_launches"] = counts
    print(f"[bench] launches {json.dumps(counts)} | {line}", flush=True)


KERNELS = [
    # name, source, replaces, the report entry with its times
    ("haplotag_score", "duet_tpu_torch/csrc/haplotag_score.cu",
     "duet_tpu/ops/pallas_haplotag.py:92", "kernel"),
    ("haplotag_score_shared", "duet_tpu_torch/csrc/haplotag_score.cu",
     "duet_tpu/ops/pallas_haplotag.py:183", "shared"),
    ("haplotag_sweep", "duet_tpu_torch/csrc/haplotag_sweep.cu",
     "duet_tpu/ops/pallas_haplotag.py:71", "sweep"),
    ("haplotag_score_pre", "duet_tpu_torch/csrc/haplotag_score.cu",
     "duet_tpu/ops/pallas_haplotag.py:37", "score_pre"),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    report: dict = {}
    work = tempfile.mkdtemp(prefix="duet_chip_smoke_")
    try:
        phase_card(report)
        phase_kernel(report)
        phase_score_edges(report)
        phase_sweep(report)
        phase_fused(report)
        phase_score_pre(report)
        phase_nn(report)
        data = phase_simulate(report, work)
        phase_pipeline_on(report, data, work)
        phase_pipeline_off(report, data, work)
        phase_pipeline_sparse(report, data, work)
        phase_bench(report)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    # launches come from each kernel's path: the pipeline on (the batched
    # scorer), the bench (sweep and shared-rhs score) and haplotag_score
    launches = {"haplotag_score": report["launches"],
                "haplotag_score_pre": report["launches_score_pre"],
                "haplotag_sweep": report["bench_launches"]["haplotag_sweep"],
                "haplotag_score_shared":
                    report["bench_launches"]["haplotag_score_shared"]}
    print(report["card"])
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": report[key]["max_abs_err"],
        "ms": report[key]["ms"],
        "plain_ms": report[key]["plain_ms"],
        "bound_ms": report[key]["bound_ms"],
        "bound_by": report[key]["bound_by"],
        "library_ms": report[key]["library_ms"],
    } for name, source, replaces, key in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
