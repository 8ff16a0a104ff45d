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
  [ingest]      the port's native ingest library (csrc/duet_ingest.cc,
                zlib inflate) built and loaded, the zlib it links, and the
                smoke BAM decoded by it (decode stats) and equal to the
                Python reader's store;
  [bgzf inflate]  the BGZF inflate kernel (csrc/bgzf_inflate.cu) byte-
                equal to zlib on members deflated at levels 0, 1, 6, 9 with
                each zlib strategy (65,280-byte members, overlapping
                matches, the empty EOF member), a flipped CRC32 bit and a
                wrong ISIZE flagged; then both benchmark cells' inputs
                (h100_bench.sim, fixed seeds): the kernel alone on each
                BAM's members, its stream equal to zlib's, and native
                ingest on the card route against the zlib pool, in turns,
                the stores equal, with the inflate seconds of each;
  [pileup kernel]  the device pileup's two kernels (csrc/pileup.cu:
                pileup_count, pileup_call) against their plain versions on
                PILEUP_EDGE_CASES at 1 and 40 times their size and on the
                smoke store's grouped window, where each is timed beside
                the first kernel pair's time, with the count's tile size,
                its ops off the tiles (second_path_ops; none here) and
                each kernel's device time by pass;
  [snp features]  the neural caller's candidate and feature kernels
                (csrc/snp_features.cu: cand_count, cand_compact,
                cand_features) against their torch twins on
                SNP_FEATURE_EDGE_CASES and at the q10-10x cell's shape,
                where they are timed beside the twins, the counts' upload
                and their bound;
  [pipeline on] the batch pipeline through the port's CLI with
                --device-stages on (the device pileup on its kernels, the
                dense scorer and its hand kernel), every stage on the
                device, the ingest native and its BGZF members inflated
                by bgzf_inflate (the kernels line's launches of it are
                this run's);
  [pipeline off]  the same CLI with --device-stages off: byte-identical;
  [pipeline auto]  --device-stages auto, the default, twice in turns
                with off: byte-identical to off, its recorded gates the
                committed ones, and each stage's route the one those gates
                give at the smoke's sizes (the read scoring with auto's
                scorer, the sparse COO scatter, whose device cost stands
                beside the dense route's); its median total beside off's
                and on's; then auto --snp-model counts, whose pileup the
                pileup gate sends to the card (its kernels launched);
  [fresh]       the CLI as a user starts it, a process of its own a run,
                off, auto, on, on, auto, off: byte-identical to off, each
                run's total and stages (the card's first use in a process
                included: the card starts, and the phasing kernels first
                run, on a thread beside ingest);
  [pileup split]  the device pileup on the smoke store: the two kernels'
                time beside the upload's, the op table, the host packers
                beside the payload packed on the card (equal bytes), two
                steady grouped launches beside [pipeline on]'s first use,
                the at-site pass serial and on the pool;
  [stream]      --stream --device-stages on (contig-major, each contig's
                reads scored by the batched kernel on its own): native
                ingest, byte-identical to the batch run;
  [resume]      --resume on a copy of the batch run's calling stages:
                byte-identical, the phasing rerun on the kernel;
  [phase-only]  --phase-only from the batch run's SV calls and haplotag
                tables: the same phased_sv.vcf;
  [flags]       --snp-model nn --haplotag-bam under on and under off: every
                artifact byte-identical, the haplotagged BAMs included;
                each mode's snp_phasing beside its run without
                --haplotag-bam, the host's cores and -t;
  [haplotag bam]  the haplotagged-BAM writer on each contig with [flags]'s
                tags: encode, compress and index seconds and MB at -t's
                default, one thread and every core, equal to the
                pipeline's files,
                and the per-read writer with its re-read index on one
                contig (the same bytes);
  [bench]       `python -m duet_tpu_torch.bench`'s full run in process;
  [mesh]        the (dp, sp) mesh as logical shards of card 0: the sharded
                phase-and-tag (2 x 2 and 1 x 4, sweeps 0 and 2) against the
                single-device phase_and_tag, the sharded clustering (sp = 4)
                against cluster_host on the smoke's signatures, the sharded
                pileup (sp = 4) against the host caller on both contigs,
                phase_contig on a 2 x 2 mesh against the single-device
                tagging on both contigs, then --mesh 1,1, --mesh auto and --stream --mesh 1,1 through
                the CLI under on (and --mesh N,1 with N > 1 cards), each
                byte-identical to the batch run with its pileup, clustering
                and scoring on the mesh;
  [profile]     --profile under on: byte-identical artifacts, a trace with
                CUDA kernel events, and the device idle share;
  [multiprocess]  two processes on card 0 joined by torch.distributed (gloo)
                at a local coordinator, each owning one contig: pileup,
                variants and phased_sv byte-identical to the batch run;
  [train]       nn_snp.train on the card at full size (duet_tpu's default
                corpus, 1200 steps, batch 16384): corpus, reader, ms a
                step, loss and train recall;
  [snp_grid]    the trained and the shipped weights on snp_grid --quick's
                cells on the card: the trained F1 within 0.02 of the
                shipped, the shipped calls equal on card and CPU;
  [crossover]   tools.haplotag_crossover on the card (dense mode through
                haplotag_score, sparse, multi-contig), outputs equal to
                the host scorer's, with its timing rows, and the dense
                route's wall a launch split into its device phases and
                the host's remainder;
  [gates]       route_crossover at 2-3 sizes a stage (phasing, SV
                clustering and the decision pass on a simulated contig's
                signatures and callset, the pileup on a store and on one
                contig): host and device routes equal, their times, the
                gates they give;
  [tools]       the demo maker, eval.evaluate of the batch run, merge of
                the batch and stream callsets, view -c on a region and on
                a whole contig (no end: equal to it bounded at its
                length), and a sweep point.

Every comparison of a kernel with its plain version is exact (torch.equal).
Times are medians of CUDA-event timed launches taken in turns (plain,
kernel, kernel, plain); beside each kernel stand its bound (the larger of
its bytes over the card's memory rate and its operations over the peak
rate for their type) and one PyTorch library call on the same inputs (a
float32 cuBLAS product; the port never calls it; none for the pileup
kernels, whose functions no one torch call computes).
Each path (the pipeline on, the pipeline auto, the stream, the resume,
haplotag_score, the bench, --profile, each process of the multi-process
run, the crossover tool, the mesh's pileup) runs with the launch counts
set to 0 just before it and read just after, and fails if a kernel of
that path never launched (auto's read scorer, the sparse COO scatter,
launches none, and fails if it does).  The mesh's scoring
launches no hand kernel: as in duet_tpu, its products are plain matmuls
outside any kernel.  Any failure exits non-zero.  The second-to-last line is one JSON object describing the
kernels; the last is {"ok": true, "device": {...}}.
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


# the pileup kernels' edge cases (pileup_edge_inputs), each a window in the
# packers' layout: zero-length ops (first, in runs, between reads) and
# n_real below the real lanes as well as the pad tail op; an odd nibble
# count and ops whose keys run past the window; N bases (codes 4-7) and
# qual-fail nibbles; reference code 4 and uncovered positions; depth 2-4,
# where non-ref alleles tie for the maximum; 8 slots below the site count;
# a one-position window; nibble starts below 0, whose gather counts from
# the payload's end; ops across the seams of every count tile size from
# 1024 to 8192 positions, one stretch piled 20 times deeper; ref starts
# whose int32 keys wrap, into the window and out of it
PILEUP_EDGE_CASES = ("zero_len_pad", "odd_past_length", "n_qual_fail",
                     "ref4_depth0", "ties", "overflow", "one_position",
                     "negative_query", "tile_seams", "wrapped_keys")


def pileup_edge_inputs(case: str, scale: int = 1):
    """(ops4 (4, K) int32, payload_ref uint8, total, length, max_sites) of
    one of PILEUP_EDGE_CASES, from a seed made of the case and `scale`: ops
    laid out one after another in the payload (gaps of 0-3 nibbles), a
    tail op absorbing the pad lanes up to a power of two, params
    [n_real, 0, min_depth 3, 1/4, 3/4, min_alt 2] in row 3.  `scale`
    multiplies the ops and the positions (at 1, one count tile and one
    call CTA but at "tile_seams"; at 40, several)."""
    from duet_tpu_torch.models.snp_caller_host import _pow2

    rng = np.random.default_rng([7, PILEUP_EDGE_CASES.index(case), scale])
    L, n_ops, max_len, max_sites = 300 * scale, 400 * scale, 30, 256 * scale
    if case == "ties":
        n_ops, max_len = 300 * scale, 4
    elif case == "overflow":
        max_sites = 8
    elif case == "one_position":
        L, max_len, max_sites = 1, 3, 256
    elif case == "tile_seams":
        L, n_ops, max_len = 65_536 * scale + 300, 1_600 * scale, 60
    ln = rng.integers(1, max_len + 1, n_ops)
    ref_start = rng.integers(0, L, n_ops)
    ref_start = np.minimum(ref_start, np.maximum(L - ln, 0))
    if case == "tile_seams":
        # each op starts 0-3 positions before a multiple of 1024, seams
        # 8-11 with 20 times the ops of the others; a few ops of 3000-9000
        # positions run over several tiles
        seams = np.arange(1, L // 1024 + 1)
        weight = np.where((seams >= 8) & (seams < 12), 20.0, 1.0)
        seam = rng.choice(seams, n_ops, p=weight / weight.sum())
        long = rng.choice(n_ops, 4 * scale, replace=False)
        ln[long] = rng.integers(3_000, 9_000, len(long))
        seam[long] = rng.integers(1, L // 1024 - 9, len(long))
        ref_start = 1024 * seam - rng.integers(0, 4, n_ops)
    if case == "one_position":
        ref_start[:] = 0                 # lengths 2-3 run past position 0
    if case == "zero_len_pad":
        ln[rng.random(n_ops) < 0.3] = 0
        ln[:2] = 0
        ln[100:106] = 0
    if case == "odd_past_length":
        ref_start[::25] = L - 2          # runs past the window's end
        ref_start[7] = L + 5             # starts past it
    if case == "ref4_depth0":
        ref_start = np.minimum(ref_start, 2 * L // 3 - ln)
    q_start = np.cumsum(ln + rng.integers(0, 4, n_ops)) - ln
    if case == "odd_past_length" and (q_start[-1] + ln[-1]) % 2 == 0:
        q_start[-1] += 1                 # the last byte holds one nibble
    ns = int(q_start[-1] + ln[-1])
    # reads of two haplotypes over the reference, a tenth of the positions
    # a variant of haplotype 1, and 10% base errors; at "ties" and
    # "one_position" every base at random
    ref = rng.integers(0, 4, L)
    alt = (ref + rng.integers(1, 4, L)) % 4
    variant = rng.random(L) < 0.1
    codes = rng.integers(0, 4, ns)
    if case not in ("ties", "one_position"):
        op = np.repeat(np.arange(n_ops), ln)
        within = np.arange(len(op)) - np.repeat(np.cumsum(ln) - ln, ln)
        pos = ref_start[op] + within
        q = q_start[op] + within
        keep = (pos < L) & (rng.random(len(op)) >= 0.1)
        p, hap = pos[keep], rng.integers(0, 2, n_ops)[op[keep]] > 0
        codes[q[keep]] = np.where(hap & variant[p], alt[p], ref[p])
    codes |= 8
    if case == "n_qual_fail":
        n_base = rng.random(ns) < 0.2
        codes[n_base] = rng.integers(4, 8, ns)[n_base] | 8
        codes[rng.random(ns) < 0.2] &= 7
    real = int(ln.sum())
    total = _pow2(real + 1)
    n_real = real - 7 if case == "zero_len_pad" else real
    ops4 = np.zeros((4, _pow2(n_ops + 2)), np.int32)
    ops4[0, :n_ops], ops4[1, :n_ops], ops4[2, :n_ops] = ref_start, q_start, ln
    ops4[2, n_ops] = total - real
    ops4[3, :8] = (n_real, 0, 3, 1, 4, 3, 4, 2)
    nb = max(_pow2(ns), total, 2) // 2
    payload = np.zeros(nb + L, np.uint8)
    padded = np.zeros(2 * nb, np.uint8)
    padded[:ns] = codes
    if case == "negative_query":         # a wrapped gather reads counted codes
        padded[ns:] = rng.integers(0, 4, 2 * nb - ns) | 8
    payload[:nb] = padded[0::2] | (padded[1::2] << 4)
    if case == "ref4_depth0":
        ref[rng.random(L) < 0.2] = 4
    payload[nb:] = ref
    if case == "negative_query":
        # a tenth of the ops start their nibbles in [-2 nb, -1]: half of
        # them cross nibble 0, two start below -2 nb (clamped to byte 0)
        sel = rng.choice(n_ops, n_ops // 10, replace=False)
        ops4[1, sel] = rng.integers(-2 * nb, 0, len(sel))
        half = sel[:len(sel) // 2]
        ops4[1, half] = -rng.integers(1, np.maximum(ln[half], 2))
        ops4[1, sel[:2]] = (-2 * nb - 1, -3 * nb)
    elif case == "wrapped_keys":
        # an eighth of the ops get ref starts whose keys wrap in int32:
        # below 0; near -2^30 and 2^30, where 4 x ref wraps past 2^32 into
        # [0, 4L) or out of it; near 2^31 - 1, where ref + within wraps
        groups = np.array_split(rng.choice(n_ops, n_ops // 8, replace=False),
                                5)
        for g, (lo, hi) in zip(groups, [(-40, 0), (-2**30, -2**30 + L),
                                        (2**30 - 20, 2**30),
                                        (2**30, 2**30 + 2 * L),
                                        (2**31 - 21, 2**31 - 1)]):
            ops4[0, g] = rng.integers(lo, hi, len(g))
    return ops4, payload, total, L, max_sites


# the neural caller's candidate and feature passes (csrc/snp_features.cu):
# argmax ties among the non-ref alleles; reference codes of 4 and above;
# candidates within the window's half-width of either end, and images
# shorter than a window; zero-depth rows inside the windows; depths
# around and far above 100; no candidate at all; the numpy counting's
# int64 counts
SNP_FEATURE_EDGE_CASES = ("ties", "ref_n", "edges", "short", "zero_depth",
                          "deep", "none", "int64")
# the q10-10x.auto cell's contig: 6 Mb at 10x with ~10% read error
SNP_CELL_POSITIONS = 6_000_000


def snp_feature_counts(L: int, seed: int, coverage: float = 10.0,
                       error: float = 0.10, dtype=np.int32):
    """((L, 4) counts, (L,) uint8 reference codes) of reads at `coverage`
    with `error` spread over the three other bases: a het SNP at 0.0013 of
    the positions (half the reads carry the alt), a reference N at 0.001."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, L).astype(np.uint8)
    depth = rng.poisson(coverage, L)
    snp = rng.random(L) < 0.0013
    n_alt = np.where(snp, rng.binomial(depth, 0.5), 0)
    n_err = rng.binomial(depth - n_alt, error)
    e1 = rng.binomial(n_err, 1 / 3)
    e2 = rng.binomial(n_err - e1, 0.5)
    counts = np.zeros((L, 4), dtype)
    rows = np.arange(L)
    r = ref.astype(np.int64)
    counts[rows, r] = depth - n_alt - n_err
    for k, e in ((1, e1), (2, e2), (3, n_err - e1 - e2)):
        counts[rows, (r + k) % 4] += e
    counts[rows, (r + rng.integers(1, 4, L)) % 4] += n_alt
    ref[rng.random(L) < 0.001] = 4
    return counts, ref


def snp_feature_edge_inputs(case: str):
    """((L, 4) counts, (L,) uint8 reference codes) of one of
    SNP_FEATURE_EDGE_CASES, from a seed made of the case."""
    rng = np.random.default_rng([11, SNP_FEATURE_EDGE_CASES.index(case)])
    L = 3_000
    if case == "int64":
        return snp_feature_counts(20_000, 5, dtype=np.int64)
    counts = rng.integers(0, 5, (L, 4)).astype(np.int32)  # ties throughout
    ref = rng.integers(0, 4, L).astype(np.uint8)
    if case == "ref_n":
        n_rows = rng.random(L) < 0.3
        ref[n_rows] = rng.choice(np.array([4, 5, 7, 255], np.uint8),
                                 int(n_rows.sum()))
    elif case == "edges":
        counts[:] = 0
        ref[:] = 0
        for p in (0, 1, 2, 3, 4, 5, L - 6, L - 5, L - 4, L - 3, L - 2, L - 1):
            counts[p] = (1, 3, 2, 0)
        counts[[7, L - 8]] = (40, 0, 0, 0)
    elif case == "short":
        counts, ref = counts[:5].copy(), ref[:5].copy()
        counts[:, 1] += 3
        ref[:] = 0
    elif case == "zero_depth":
        counts[rng.random(L) < 0.4] = 0
    elif case == "deep":
        counts = rng.integers(0, 400, (L, 4)).astype(np.int32)
        counts[::7] = (97, 1, 1, 1)
        counts[1::7] = (0, 99, 1, 1)
        counts[2::7] = (60, 40, 1, 0)
        counts[3::7] = rng.integers(2_000, 20_000, (len(counts[3::7]), 4))
    elif case == "none":
        counts[:] = 0
        counts[np.arange(L), ref] = rng.integers(0, 50, L)
        counts[::3, (ref[::3] + 1) % 4] = 1
    return counts, ref


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


PILEUP_KERNELS = ("pileup_count", "pileup_call")
# the launches of csrc/pileup.cu's two entries, by kernel name
PILEUP_PASSES = (r"(op_block_sums|scan_kernel|op_tiles|op_scatter|"
                 r"tile_count|second_path|call_bits|compact_sites)")
SNP_FEATURE_KERNELS = ("cand_count", "cand_compact", "cand_features")
# the launches of csrc/snp_features.cu's three entries
SNP_FEATURE_PASSES = r"(cand_count|scan_kernel|cand_compact|cand_features)"


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
    v = re.search(r"(cand_count|cand_compact|cand_features)I([ix])E",
                  mangled)
    if v:
        width = "int64" if v.group(2) == "x" else "int32"
        return f"snp_features {v.group(1)}<{width} counts>"
    v = re.search(PILEUP_PASSES, mangled)
    if v:   # scan_kernel: pileup.cu's and snp_features.cu's each
        return v.group(1) if v.group(1) == "scan_kernel" else \
            f"pileup {v.group(1)}"
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
    libs = ("haplotag_score", "haplotag_sweep", "pileup", "snp_features",
            "bgzf_inflate")
    builds = ", ".join(
        f"{n} {cuda_build.BUILD_INFO[n]['seconds']} s (fresh build: "
        f"{cuda_build.BUILD_INFO[n]['built']})" for n in libs)
    report["ptxas"] = ptxas = [
        info for n in libs
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


def _run_cli(data: str, out: str, mode: str, *flags: str) -> dict:
    from duet_tpu_torch.cli import main as cli_main

    rc = cli_main([os.path.join(data, "reads.bam"),
                   os.path.join(data, "ref.fa"), out,
                   "--device-stages", mode, *flags])
    if rc != 0:
        raise AssertionError(f"duet-tpu-torch --device-stages {mode} "
                             f"{' '.join(flags)} exited {rc}")
    with open(os.path.join(out, "metrics.json")) as f:
        return json.load(f)


def phase_ingest(report: dict, data: str) -> None:
    """The native ingest on this machine: built from the port's zlib copy
    of the ingest source, it decodes the smoke BAM into the Python
    reader's store."""
    import ctypes

    from duet_tpu_torch.io import native_ingest
    from duet_tpu_torch.io.readstore import load_read_store
    from duet_tpu_torch.utils import spans

    t = time.perf_counter()
    lib = native_ingest.get_lib()
    build_s = time.perf_counter() - t
    lib.zlibVersion.restype = ctypes.c_char_p
    bam = os.path.join(data, "reads.bam")
    spans.reset("ingest.")
    t = time.perf_counter()
    store = native_ingest.load_read_store_native(
        bam, n_threads=min(4, os.cpu_count() or 1))
    native_s = time.perf_counter() - t
    stats = native_ingest.decode_stats()
    t = time.perf_counter()
    want = load_read_store(bam)
    python_s = time.perf_counter() - t
    if list(store.contigs) != list(want.contigs) or \
            store.contig_lengths != want.contig_lengths:
        raise AssertionError("the native store holds other contigs")
    for c, cr in want.contigs.items():
        got = store.contigs[c]
        if got.names != cr.names:
            raise AssertionError(f"native ingest: {c} read names differ")
        for f in ("starts", "ends", "strand", "mapq", "supp", "cigar_off",
                  "cigar_ops", "cigar_lens", "seq_off", "seq", "qual"):
            if not np.array_equal(getattr(got, f), getattr(cr, f)):
                raise AssertionError(f"native ingest: {c}.{f} differs")
    n_reads = sum(c.n for c in store.contigs.values())
    report["store"] = store
    print(f"[ingest] zlib route: <zlib.h> + {' '.join(native_ingest._LDFLAGS)}"
          f" (zlib {lib.zlibVersion().decode()}), library "
          f"{os.path.relpath(native_ingest._so_path())} ready in "
          f"{build_s:.1f} s; decoded {n_reads} reads in {native_s:.3f} s "
          f"(Python reader {python_s:.3f} s), "
          f"store equal to the Python reader's; stats {json.dumps(stats)}",
          flush=True)


# the BGZF inflate kernel's cases: each zlib level and strategy
BGZF_LEVELS = (0, 1, 6, 9)
BGZF_STRATEGIES = {"default": 0, "filtered": 1, "huffman_only": 2, "rle": 3,
                   "fixed": 4}
# the benchmark cells' configurations, simulated by h100_bench.sim
BGZF_CELL_CONFIGS = {"q10-10x": "synth-ont-q10-10x",
                     "q20-20x": "synth-ont-q20-20x"}


def bgzf_member(data: bytes, level: int = 6, strategy: int = 0) -> bytes:
    """One BGZF member of `data` (at most 65,536 bytes), deflated by zlib
    at `level` with `strategy`, framed as the BAM writer frames it."""
    import struct
    import zlib

    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    raw = c.compress(data) + c.flush()
    return (b"\x1f\x8b\x08\x04\0\0\0\0\0\xff\x06\0BC\x02\0" +
            struct.pack("<H", 25 + len(raw)) + raw +
            struct.pack("<II", zlib.crc32(data), len(data)))


def bgzf_edge_members(level: int, strategy: int) -> list[tuple[str, bytes]]:
    """Members at `level` and `strategy`: a BAM-like 65,280-byte block
    (quality strings and bases), overlapping matches (runs of one and two
    bytes, a three-byte period), random bytes, text and one byte; and the
    empty EOF member."""
    from duet_tpu_torch.io.bgzf import BGZF_EOF

    rng = np.random.default_rng(1000 + 10 * level + strategy)
    quals = (33 + np.clip(rng.normal(22, 8, 40_000), 0, 60)).astype(np.uint8)
    bases = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 25_280)]
    datas = {"bam_like_65280": quals.tobytes() + bases.tobytes(),
             "overlap": b"ab" * 3000 + b"a" * 5000 + b"xyz" * 900,
             "random": rng.bytes(4096),
             "text": b"the quick brown fox jumps over the lazy dog " * 200,
             "one": b"q"}
    return [(name, bgzf_member(d, level, strategy))
            for name, d in datas.items()] + [("eof", BGZF_EOF)]


def bgzf_faults(member: bytes) -> dict[str, bytes]:
    """`member` with a CRC32 bit flipped, its ISIZE one too many, and its
    DEFLATE data cut to half (BSIZE true to the shorter member)."""
    import struct

    crc = bytearray(member)
    crc[-8] ^= 0x01
    isize = member[:-4] + struct.pack(
        "<I", struct.unpack("<I", member[-4:])[0] + 1)
    keep = (len(member) - 26) // 2
    cut = bytearray(member[:18 + keep] + member[-8:])
    cut[16:18] = struct.pack("<H", len(cut) - 1)
    return {"crc32": bytes(crc), "isize": isize, "truncated": bytes(cut)}


def bgzf_on_card(members: list[bytes]):
    """The kernel on `members` concatenated: (out bytes, statuses), and
    zlib's (the plain counterpart) for the same members."""
    import torch

    from duet_tpu_torch.ops.bgzf_inflate import inflate_members, member_table

    buf = b"".join(members)
    table = torch.from_numpy(member_table(buf))
    comp = torch.frombuffer(bytearray(buf), dtype=torch.uint8)
    out, status = inflate_members(comp.cuda(), table.cuda())
    torch.cuda.synchronize()
    want_out, want_status = inflate_members(comp, table)
    return (out.cpu().numpy().tobytes(), status.cpu().tolist(),
            want_out.numpy().tobytes(), want_status.tolist())


def _sim_cell_inputs(work: str) -> dict:
    """Each cell's input, seed 2147483701, written by h100_bench.sim in
    processes of their own, at once."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    for cell, config in BGZF_CELL_CONFIGS.items():
        out = os.path.join(work, f"cell_{cell}")
        procs[cell] = (out, subprocess.Popen(
            [sys.executable, "-m", "h100_bench.sim",
             os.path.join(here, "h100_bench", "configs", f"{config}.json"),
             "2147483701", out], cwd=here))
    for cell, (_, p) in procs.items():
        if p.wait(timeout=600) != 0:
            raise AssertionError(f"h100_bench.sim failed for {cell}")
    return {cell: os.path.join(out, "reads.bam")
            for cell, (out, _) in procs.items()}


def _bgzf_kernel_ms(comp, rows) -> float:
    """The kernel's launch alone on a whole BAM's members (buffers made
    first), median of 10 after 3."""
    import torch

    from duet_tpu_torch.ops import bgzf_inflate

    padded = torch.zeros(comp.numel() + 64, dtype=torch.uint8,
                         device=comp.device)
    padded[:comp.numel()] = comp
    n = rows.shape[0]
    out = torch.empty(int((rows[:, 2] + rows[:, 3]).max()),
                      dtype=torch.uint8, device=comp.device)
    status = torch.zeros(n + 1, dtype=torch.int32, device=comp.device)
    stream = torch.cuda.current_stream(comp.device).cuda_stream
    lib = bgzf_inflate._library()

    def launch():
        if lib.duet_bgzf_launch(padded.data_ptr(), rows.data_ptr(), n,
                                out.data_ptr(), status.data_ptr(), stream):
            raise AssertionError("bgzf_inflate launch failed")

    return _median_ms(launch, reps=10)


def phase_bgzf_inflate(report: dict, work: str) -> None:
    """The BGZF inflate kernel against zlib on every level and strategy,
    its checks on bad trailers, and both cells' inputs through the kernel
    alone and through native ingest's card route against the zlib pool."""
    import torch

    from duet_tpu_torch.io import native_ingest
    from duet_tpu_torch.io.bgzf import bgzf_decompress_file
    from duet_tpu_torch.ops import bgzf_inflate
    from duet_tpu_torch.utils import spans

    t0 = time.perf_counter()
    n_members = 0
    for level in BGZF_LEVELS:
        for sname, strategy in BGZF_STRATEGIES.items():
            named = bgzf_edge_members(level, strategy)
            out, status, want, want_status = bgzf_on_card(
                [m for _, m in named])
            if out != want or any(status) or any(want_status):
                raise AssertionError(f"bgzf_inflate: level {level} {sname}: "
                                     f"statuses {status}, zlib's "
                                     f"{want_status}")
            n_members += len(named)
    good = bgzf_edge_members(6, 0)[0][1]
    faults = {}
    for fault, member in bgzf_faults(good).items():
        _, status, _, want_status = bgzf_on_card([good, member, good])
        faults[fault] = status[1]
        if status[0] or status[2] or not status[1] or not want_status[1] or \
                status[3] != status[1]:
            raise AssertionError(f"bgzf_inflate: {fault}: statuses {status}, "
                                 f"zlib's {want_status}")
    if faults["crc32"] != 3 or faults["isize"] != 4:
        raise AssertionError(f"bgzf_inflate: fault statuses {faults}")
    dev = torch.device("cuda", 0)
    cells = {}
    for cell, bam in _sim_cell_inputs(work).items():
        with open(bam, "rb") as f:
            buf = f.read()
        table = torch.from_numpy(bgzf_inflate.member_table(buf))
        comp = torch.frombuffer(bytearray(buf), dtype=torch.uint8).to(dev)
        rows = table.to(dev)
        out, status = bgzf_inflate.inflate_members(comp, rows)
        torch.cuda.synchronize()
        if status.cpu().max().item() != 0 or \
                out.cpu().numpy().tobytes() != bgzf_decompress_file(bam):
            raise AssertionError(f"bgzf_inflate: {cell}: the stream differs "
                                 "from zlib's")
        kernel_ms = _bgzf_kernel_ms(comp, rows)
        longest = int(table[:, 3].max())
        routes: dict = {"host": [], "card": []}
        stores = {}
        for route in ("host", "card", "card", "host"):
            spans.reset()
            t = time.perf_counter()
            stores[route] = native_ingest.load_read_store_native(
                bam, n_threads=4,
                inflate_device=dev if route == "card" else None)
            wall = time.perf_counter() - t
            stats = native_ingest.decode_stats()
            routes[route].append({"decode_s": round(wall, 4),
                                  "inflate_s": stats["inflate_s"]})
        for c, cr in stores["host"].contigs.items():
            got = stores["card"].contigs[c]
            if got.names != cr.names or any(
                    not np.array_equal(getattr(got, f), getattr(cr, f))
                    for f in ("starts", "ends", "strand", "mapq", "supp",
                              "cigar_off", "cigar_ops", "cigar_lens",
                              "seq_off", "seq", "qual")):
                raise AssertionError(f"bgzf_inflate: {cell}: the card "
                                     f"route's store differs at {c}")
        nbytes = len(buf) + int(table[:, 3].sum())
        cells[cell] = {
            "compressed_bytes": len(buf), "members": len(table),
            "inflated_bytes": int(table[:, 3].sum()), "longest": longest,
            "kernel_ms": kernel_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "host_inflate_ms": 1e3 * float(np.median(
                [r["inflate_s"] for r in routes["host"]])),
            "card_inflate_ms": 1e3 * float(np.median(
                [r["inflate_s"] for r in routes["card"]])),
            "routes": routes}
    q10 = cells["q10-10x"]
    report["bgzf_inflate"] = {
        "ms": q10["kernel_ms"], "plain_ms": q10["host_inflate_ms"],
        "bound_ms": q10["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "max_abs_err": 0, "cells": cells}
    print(f"[bgzf inflate] {n_members} members over levels {BGZF_LEVELS} x "
          f"{list(BGZF_STRATEGIES)} byte-equal to zlib; fault statuses "
          f"{json.dumps(faults)}; cells {json.dumps(cells)}; "
          f"{time.perf_counter() - t0:.1f} s on {report['card']}", flush=True)


# the first kernel pair's medians on the smoke's grouped window (a global
# atomic a kept lane; the histogram read twice by the call), on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md section 6), printed beside this run's
FIRST_PILEUP_MS = {"pileup_count": 3.3977, "pileup_call": 0.2415}


def _pass_split(fn, reps: int = 5, passes: str = PILEUP_PASSES) -> dict:
    """Device microseconds a call of `fn` spends in each kernel it
    launches, by pass name (the group of `passes`; torch.profiler over
    `reps` calls)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split: dict = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        v = re.search(passes, e.key)
        if us > 0 and v:
            split[v.group(1)] = split.get(v.group(1), 0) + us / reps
    if not split:
        raise AssertionError(f"torch.profiler saw no kernel of {passes}")
    return {k: round(v, 1) for k, v in split.items()}


def phase_pileup_kernel(report: dict, data: str) -> None:
    """Both pileup kernels against their plain versions, exactly (the bins
    with their sentinel, then the whole flat output): every edge case at 1
    and 40 times its size, then the smoke store's grouped window, the
    window [pipeline on] launches, where no op may leave the count's
    tiles; each kernel's time there in turns beside its plain version's,
    its bound and the first kernel pair's time."""
    import torch

    from duet_tpu_torch.io.fasta import FastaFile
    from duet_tpu_torch.models.snp_caller import (_payload_on_device,
                                                  group_tables, window_ops)
    from duet_tpu_torch.models.snp_caller_host import (
        DEVICE_MAX_SITE_DENSITY, SnpCallConfig, _as_rational, _pow2)
    from duet_tpu_torch.ops.pileup import call_plain, count_plain
    from duet_tpu_torch.ops.pileup_kernel import (pileup_call, pileup_count,
                                                  pileup_count_report,
                                                  second_path_ops)

    def check(ops4, payload, total, L, max_sites, what):
        ref = payload[payload.shape[0] - L:]
        bins, seen = pileup_count_report(ops4, payload, total=total,
                                         length=L)
        want_bins = count_plain(ops4, payload, total=total, length=L)
        _require_equal([bins], [want_bins], ["the bins"], what)
        off = second_path_ops(ops4, payload, total=total, length=L)
        if seen["second_path_ops"] != off:
            raise AssertionError(f"{what}: {seen['second_path_ops']} ops "
                                 f"off the count's tiles, not {off}")
        out = pileup_call(bins, ref, ops4[3], max_sites)
        want = call_plain(want_bins, ref, ops4[3], max_sites)
        _require_equal([out], [want], ["the flat output"], what)
        return bins, out, seen, max(_max_abs_err([bins], [want_bins]),
                                    _max_abs_err([out], [want]))

    t0 = time.perf_counter()
    edges = []
    for case in PILEUP_EDGE_CASES:
        for scale in (1, 40):
            ops4, payload, total, L, max_sites = pileup_edge_inputs(case,
                                                                    scale)
            _, out, seen, _ = check(torch.from_numpy(ops4).cuda(),
                                    torch.from_numpy(payload).cuda(), total,
                                    L, max_sites, f"{case} x{scale}")
            edges.append(f"{case} x{scale} ({int(out[0])} sites, "
                         f"{seen['second_path_ops']} ops off the tiles)")

    dev = torch.device("cuda")
    store = report["store"]
    fa = FastaFile(os.path.join(data, "ref.fa"))
    cfg = SnpCallConfig(device=True)
    ref, rw, q0, ln, reads, _ = group_tables(
        [(c, cr, fa.fetch_codes(c)) for c, cr in store.contigs.items()], cfg)
    Lw = _pow2(len(ref))
    max_sites = _pow2(max(Lw // DEVICE_MAX_SITE_DENSITY, 256))
    rats = (*_as_rational(cfg.min_af), *_as_rational(cfg.hom_af))
    ops4_np, total, ns_pad = window_ops(
        cfg, rw, q0, ln, sum(len(seq) for seq, _ in reads), rats)
    ops4 = torch.from_numpy(ops4_np).to(dev)
    payload = _payload_on_device(reads, ref, ns_pad, Lw, cfg.min_base_qual,
                                 dev)
    bins, out, seen, err = check(ops4, payload, total, Lw, max_sites,
                                 "the smoke's grouped window")
    if seen["second_path_ops"]:
        raise AssertionError(f"{seen['second_path_ops']} ops of the smoke's "
                             f"window left the count's tiles")
    refc = payload[payload.shape[0] - Lw:]
    params = ops4[3]
    count_ms, count_plain_ms = _turns(
        lambda: pileup_count(ops4, payload, total=total, length=Lw),
        lambda: count_plain(ops4, payload, total=total, length=Lw),
        rounds=2, reps=5)
    call_ms, call_plain_ms = _turns(
        lambda: pileup_call(bins, refc, params, max_sites),
        lambda: call_plain(bins, refc, params, max_sites), rounds=2, reps=5)
    n_real = int(ops4_np[3, 0])
    kept = int(bins[:4 * Lw].sum())
    K = ops4_np.shape[1]
    hist = 4 * (4 * Lw + 1)
    # each input read once and each output written once: count, the real
    # lanes' nibbles and the ops' three rows in, the histogram out; call,
    # the histogram and reference codes in, the flat output out
    report["pileup_count"] = {"ms": count_ms, "plain_ms": count_plain_ms,
                              "max_abs_err": err, "library_ms": None,
                              **_bound((n_real + 1) // 2 + 12 * K + hist, 0,
                                       "fp32")}
    report["pileup_call"] = {"ms": call_ms, "plain_ms": call_plain_ms,
                             "max_abs_err": err, "library_ms": None,
                             **_bound(hist + Lw + 4 * (1 + 5 * max_sites),
                                      0, "fp32")}
    passes = {"pileup_count": _pass_split(
        lambda: pileup_count(ops4, payload, total=total, length=Lw)),
              "pileup_call": _pass_split(
        lambda: pileup_call(bins, refc, params, max_sites))}
    report["pileup_window"] = {"lanes": total, "real_lanes": n_real,
                               "kept_lanes": kept, "ops": K, "length": Lw,
                               "max_sites": max_sites,
                               "sites": int(out[0]), **seen}
    times = ", ".join(
        f"{name} median {report[name]['ms']:.4f} ms (first version "
        f"{FIRST_PILEUP_MS[name]} ms) vs plain {report[name]['plain_ms']:.4f}"
        f" ms, bound {report[name]['bound_ms']:.4f} ms "
        f"({report[name]['bound_by']}, "
        f"{report[name]['bound_ms'] / report[name]['ms']:.1%} of it)"
        for name in PILEUP_KERNELS)
    print(f"[pileup kernel] pileup_count and pileup_call == count_plain "
          f"and call_plain (torch.equal on the int32 bins and the whole "
          f"flat output), and the count's ops off its tiles == "
          f"second_path_ops, on {len(edges)} edge windows: "
          f"{', '.join(edges)}; and on the smoke's grouped window "
          f"{json.dumps(report['pileup_window'])} (tiles of "
          f"{seen['tile_positions']} positions, "
          f"{seen['second_path_ops']} ops off them): {times}; device us a "
          f"call by pass (torch.profiler): {json.dumps(passes)}; library: "
          f"none (no one torch call computes either); in "
          f"{time.perf_counter() - t0:.1f} s on {report['card']}",
          flush=True)


def _snp_features_on(counts, ref, batch: int):
    """The kernel route's candidates and the features of its `batch`-row
    chunks, on the tensors' device."""
    from duet_tpu_torch.ops import snp_features as sf

    cand = sf.candidates(counts, ref)
    pos, alt = cand[0], cand[1]
    return cand, [sf.features(counts, ref, pos[s:s + batch],
                              alt[s:s + batch])
                  for s in range(0, len(pos), batch)]


def _snp_features_plain(counts, ref, batch: int):
    """The same through the torch twins, on the tensors' device."""
    from duet_tpu_torch.ops import snp_features as sf

    cand = sf.candidates_plain(counts, ref)
    pos, alt = cand[0], cand[1]
    return cand, [sf.features_plain(counts, ref, pos[s:s + batch],
                                    alt[s:s + batch])
                  for s in range(0, len(pos), batch)]


def check_snp_features(counts: np.ndarray, ref: np.ndarray, batch: int,
                       what: str) -> int:
    """The kernels on the card against the twins on the CPU, exactly: the
    four candidate fields, then every chunk's features as bytes; n."""
    import torch

    dev = torch.device("cuda")
    got_c, got_f = _snp_features_on(torch.from_numpy(counts).to(dev),
                                    torch.from_numpy(ref).to(dev), batch)
    want_c, want_f = _snp_features_plain(torch.from_numpy(counts),
                                         torch.from_numpy(ref), batch)
    torch.cuda.synchronize()
    _require_equal([g.cpu() for g in got_c], want_c,
                   ["pos", "alt_code", "alt_count", "depth"], what)
    _require_equal([g.cpu().view(torch.int32) for g in got_f],
                   [w.view(torch.int32) for w in want_f],
                   [f"features[{k * batch}:]" for k in range(len(want_f))],
                   what)
    return len(want_c[0])


def phase_snp_features(report: dict) -> None:
    """The neural caller's candidate and feature kernels
    (csrc/snp_features.cu) against their torch twins, exactly, on
    SNP_FEATURE_EDGE_CASES in chunks of 7 rows, then at the q10-10x cell's
    shape (SNP_CELL_POSITIONS at 10x, 10% error) in nn_call_snps' chunks
    of 65,536: the kernels' time beside the twins' on the card, the
    counts' upload and the bound, and each pass's device time."""
    import torch

    from duet_tpu_torch.ops import snp_features as sf

    t0 = time.perf_counter()
    edges = []
    for case in SNP_FEATURE_EDGE_CASES:
        n = check_snp_features(*snp_feature_edge_inputs(case), 7, case)
        edges.append(f"{case} ({n} candidates)")
    batch = 65536
    counts, ref = snp_feature_counts(SNP_CELL_POSITIONS, 5)
    n = check_snp_features(counts, ref, batch, "the cell's shape")
    dev = torch.device("cuda")
    upload_ms = _median_ms(lambda: torch.from_numpy(counts).to(dev), reps=5)
    c_d = torch.from_numpy(counts).to(dev)
    r_d = torch.from_numpy(ref).to(dev)
    ms, plain_ms = _turns(lambda: _snp_features_on(c_d, r_d, batch),
                          lambda: _snp_features_plain(c_d, r_d, batch),
                          rounds=2, reps=5)
    pos, alt = sf.candidates(c_d, r_d)[:2]
    cand_ms = _median_ms(lambda: sf.candidates(c_d, r_d), reps=10)
    feat_ms = _median_ms(lambda: [sf.features(c_d, r_d, pos[s:s + batch],
                                              alt[s:s + batch])
                                  for s in range(0, n, batch)], reps=10)
    passes = _pass_split(lambda: _snp_features_on(c_d, r_d, batch),
                         passes=SNP_FEATURE_PASSES)
    L = SNP_CELL_POSITIONS
    # each input read once (the int32 counts, the reference codes) and
    # each output written once (21 bytes of candidate fields and 204 of
    # features a candidate)
    report["snp_features"] = {"ms": ms, "plain_ms": plain_ms,
                              "max_abs_err": 0, "library_ms": None,
                              **_bound(16 * L + L + (21 + 204) * n, 0,
                                       "fp32")}
    r = report["snp_features"]
    print(f"[snp features] cand_count + cand_compact and cand_features == "
          f"candidates_plain and features_plain (torch.equal on the four "
          f"candidate fields and on the features' bytes, chunks of 7) on "
          f"{', '.join(edges)}; at the q10-10x cell's shape (L = {L}, "
          f"{n} candidates, {n / L:.1%}, chunks of {batch}): the three "
          f"passes {ms:.4f} ms (candidates with the readback of n "
          f"{cand_ms:.4f}, features {feat_ms:.4f}) vs the twins on the "
          f"card {plain_ms:.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}, {r['bound_ms'] / ms:.1%} of it); the counts' "
          f"pageable upload {upload_ms:.3f} ms "
          f"({16 * L / upload_ms / 1e6:.2f} GB/s); device us a call by "
          f"pass (torch.profiler): {json.dumps(passes)}; library: none; in "
          f"{time.perf_counter() - t0:.1f} s on {report['card']}",
          flush=True)


def _reset_launches() -> None:
    import torch

    from duet_tpu_torch.ops import (bgzf_inflate, haplotag_kernel,
                                    pileup_kernel, snp_features)

    torch.cuda.synchronize()
    haplotag_kernel.reset_launches()
    pileup_kernel.reset_launches()
    snp_features.reset_launches()
    bgzf_inflate.reset_launches()


def _launches() -> dict:
    """Every kernel's launches since the last _reset_launches."""
    from duet_tpu_torch.ops import (bgzf_inflate, haplotag_kernel,
                                    pileup_kernel, snp_features)

    return {**haplotag_kernel.LAUNCHES, **pileup_kernel.LAUNCHES,
            **snp_features.LAUNCHES, **bgzf_inflate.launches()}


def _all_on_device(metrics: dict, path: str) -> None:
    # the BGZF inflate's device route is the card's kernel
    wrong = {s: b for s, b in metrics["backends"].items()
             if b != ("card" if s == "ingest_inflate" else "device")}
    if wrong:
        raise AssertionError(f"{path}: stages not on the device: {wrong}")


def phase_pipeline_on(report: dict, data: str, work: str) -> None:
    _reset_launches()
    t = time.perf_counter()
    metrics = _run_cli(data, os.path.join(work, "on"), "on")
    report["pipeline_on_wall"] = time.perf_counter() - t
    counts = _launches()
    report["launches"] = counts["haplotag_score"]
    report["pileup_launches"] = {k: counts[k] for k in PILEUP_KERNELS}
    report["bgzf_launches"] = counts["bgzf_inflate"]
    _all_on_device(metrics, "the pipeline")
    _require_launches(counts, ["haplotag_score"], "the pipeline (dense)")
    _require_launches(counts, PILEUP_KERNELS, "the pipeline")
    _require_launches(counts, ["bgzf_inflate"], "the pipeline")
    if metrics["ingest"]["backend"] != "native":
        raise AssertionError(f"the pipeline ingested with "
                             f"{metrics['ingest']['backend']}, not native")
    report["pipeline_on"] = metrics
    print(f"[pipeline on] backends all device, haplotag_score launches "
          f"{report['launches']}, pileup kernel launches "
          f"{json.dumps(report['pileup_launches'])}, bgzf_inflate launches "
          f"{report['bgzf_launches']}, "
          f"wall {report['pipeline_on_wall']:.2f} s, "
          f"ingest {metrics['ingest']['backend']}, "
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
    before = _launches()
    metrics = _run_cli(data, os.path.join(work, "off"), "off")
    if _launches() != before:
        raise AssertionError("--device-stages off launched a kernel")
    on = os.path.join(work, "on")
    n = _compare_artifacts(on, os.path.join(work, "off"))
    with open(os.path.join(on, "phased_sv.vcf")) as f:
        n_phased = sum(1 for ln in f if ln.strip() and not ln.startswith("#"))
    if n_phased == 0:
        raise AssertionError("the run phased no SV call")
    report["pipeline_off"] = metrics
    print(f"[pipeline off] {n} artifacts byte-identical to the "
          f"device run ({n_phased} phased SV calls); host total "
          f"{metrics['total_s']} s, stages {json.dumps(metrics['stages'])}",
          flush=True)


def _expected_auto_backends(report: dict, work: str, gates: dict) -> dict:
    """The stage labels that auto's committed gates give at the smoke's
    sizes: its read bases, each contig's signatures and allele-matrix
    entries, and its SV calls."""
    from duet_tpu_torch.io.vcf import parse_sv_vcf
    from duet_tpu_torch.models.snp_caller_host import (SnpCallConfig,
                                                       read_pileup_vcf)
    from duet_tpu_torch.models.snp_phaser_host import build_allele_matrix

    def on(size, gate):
        return gate is not None and size >= gate

    def label(routes):
        order = {"device": 0, "host": 1}
        return "+".join(sorted(set(routes), key=order.get))

    store = report["store"]
    off = os.path.join(work, "off")
    bases = sum(len(cr.seq) for cr in store.contigs.values())
    k = {}
    for contig, _, pos, _, _ in _smoke_signatures(store):
        k[contig] = k.get(contig, 0) + len(pos)
    snps = read_pileup_vcf(os.path.join(off, "snp_calling", "pileup.vcf.gz"))
    nnz = {c: len(build_allele_matrix(store.contigs[c], s,
                                      SnpCallConfig()).row)
           for c, s in snps.items()}
    calls = sum(len(v) for v in parse_sv_vcf(
        os.path.join(off, "sv_calling", "variants.vcf"), False).values())
    report["auto_sizes"] = {"pileup_bases": bases, "sv_signatures": k,
                            "phasing_nnz": nnz, "decide_calls": calls}
    # the default --snp-model auto keeps the pileup on the host
    return {
        "snp_pileup": report["pipeline_off"]["backends"]["snp_pileup"],
        "sv_cluster": label("device" if on(v, gates[
            "sv_cluster_min_signatures"]) else "host"
                            for v in k.values() if v),
        "phase_refine": label("device" if on(v, gates["phasing_min_nnz"])
                              else "host" for v in nnz.values() if v),
        "haplotag": "device" if on(sum(nnz.values()),
                                   gates["phasing_min_nnz"]) else "host",
        "sv_decide": "device" if on(calls, gates["decide_min_calls"])
        else "host",
        # the card inflates whenever the stages run on one
        "ingest_inflate": "card",
    }


def phase_pipeline_auto(report: dict, data: str, work: str) -> None:
    """--device-stages auto, the default, in turns with off (off, auto,
    auto, off): byte-identical to off, the gates it records are the
    committed ones, each stage ran where those gates send the smoke's
    sizes, and its median total stands beside off's and on's."""
    from duet_tpu_torch.pipeline import PipelineConfig

    gates = PipelineConfig(bam="", reference="",
                           output="").device_size_gates()
    want = None
    totals = {"auto": [], "off": [report["pipeline_off"]["total_s"]]}
    for turn, mode in enumerate(("off", "auto", "auto", "off")):
        out = os.path.join(work, f"{mode}{turn}")
        _reset_launches()
        metrics = _run_cli(data, out, mode)
        counts = _launches()
        totals[mode].append(metrics["total_s"])
        n = _compare_artifacts(out, os.path.join(work, "off"))
        if mode == "off":
            continue
        if metrics["device_size_gates"] != gates:
            raise AssertionError(f"auto recorded the gates "
                                 f"{metrics['device_size_gates']}, not "
                                 f"{gates}")
        want = want or _expected_auto_backends(report, work, gates)
        if metrics["backends"] != want:
            raise AssertionError(f"auto ran {metrics['backends']}, the "
                                 f"gates predict {want} at "
                                 f"{report['auto_sizes']}")
        if want["haplotag"] == "device" and gates["haplotag_mode"] == "dense":
            _require_launches(counts, ["haplotag_score"], "the auto pipeline")
        elif counts["haplotag_score"]:
            raise AssertionError("the sparse scorer launched a dense kernel")
        _require_launches(counts, ["bgzf_inflate"], "the auto pipeline")
        # the pileup gates route the counting rule only
        if counts["pileup_count"] or counts["pileup_call"]:
            raise AssertionError(f"auto launched the pileup kernels under "
                                 f"--snp-model auto: {counts}")
        report["pipeline_auto"] = metrics
    # --snp-model counts: the pileup goes to the card from its gate (the
    # whole store's: a batch run)
    counting_gates = PipelineConfig(bam="", reference="", output="",
                                    snp_model="counts").device_size_gates()
    _reset_launches()
    counting = _run_cli(data, os.path.join(work, "auto_counts"), "auto",
                        "--snp-model", "counts")
    counts_counting = _launches()
    _compare_artifacts(os.path.join(work, "auto_counts"),
                       os.path.join(work, "off"))
    if counting["device_size_gates"] != counting_gates:
        raise AssertionError(f"auto --snp-model counts recorded the gates "
                             f"{counting['device_size_gates']}, not "
                             f"{counting_gates}")
    bases = report["auto_sizes"]["pileup_bases"]
    route = "device" if bases >= counting_gates["pileup_min_bases"] \
        else "host"
    if counting["backends"] != {**want, "snp_pileup": route}:
        raise AssertionError(f"auto --snp-model counts ran "
                             f"{counting['backends']}; the gates predict the "
                             f"pileup on the {route} at {bases} bases")
    if route == "device":
        _require_launches(counts_counting, PILEUP_KERNELS,
                          "auto --snp-model counts")
    metrics = report["pipeline_auto"]
    on = report["pipeline_on"]
    scorer = ""
    if want["haplotag"] == "device":
        scorer = (f"; haplotag device_cost {gates['haplotag_mode']} "
                  f"{json.dumps(metrics['device_cost']['haplotag'])} against "
                  f"on's dense {json.dumps(on['device_cost']['haplotag'])}, "
                  f"snp_phasing {metrics['stages']['snp_phasing']} s against "
                  f"{on['stages']['snp_phasing']} s")
    auto_s = float(np.median(totals["auto"]))
    best = min(float(np.median(totals["off"])), on["total_s"])
    print(f"[pipeline auto] {n} artifacts byte-identical to off in each of "
          f"2 runs; gates {json.dumps(gates)}; sizes "
          f"{json.dumps(report['auto_sizes'])}; backends "
          f"{json.dumps(metrics['backends'])} as the gates predict; "
          f"haplotag_score launches {counts['haplotag_score']}{scorer}; "
          f"totals auto {totals['auto']} s (median {auto_s:.4f}), off "
          f"{totals['off']} s, on {on['total_s']} s: auto "
          f"{auto_s / best:.3f} x the faster median; stages "
          f"{json.dumps(metrics['stages'])}; device_cost "
          f"{json.dumps(metrics['device_cost'])}; --snp-model counts: "
          f"byte-identical, the pileup on the {route} at {bases} bases "
          f"(pileup launches {counts_counting['pileup_count']} / "
          f"{counts_counting['pileup_call']}), total "
          f"{counting['total_s']} s, stages "
          f"{json.dumps(counting['stages'])}", flush=True)


def phase_fresh(report: dict, data: str, work: str) -> None:
    """The CLI as a user starts it, one fresh process a run, in turns (off,
    auto, on, on, auto, off): each run's artifacts byte-identical to
    [pipeline off]'s, and its total, stages and backends, so that what the
    card's first use in a process costs under auto and on shows."""
    runs: dict = {"off": [], "auto": [], "on": []}
    t = time.perf_counter()
    for turn, mode in enumerate(("off", "auto", "on", "on", "auto", "off")):
        out = os.path.join(work, f"fresh_{mode}{turn}")
        t_run = time.perf_counter()
        subprocess.run([sys.executable, "-m", "duet_tpu_torch",
                        os.path.join(data, "reads.bam"),
                        os.path.join(data, "ref.fa"), out,
                        "--device-stages", mode], check=True,
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                       timeout=300)
        process_s = time.perf_counter() - t_run
        _compare_artifacts(out, os.path.join(work, "off"))
        with open(os.path.join(out, "metrics.json")) as f:
            m = json.load(f)
        pileup = m["device_cost"].get("snp_pileup", {})
        runs[mode].append({"process_s": round(process_s, 3),
                           "total_s": m["total_s"], "stages": m["stages"],
                           "backends": m["backends"],
                           "pileup_h2d_s": pileup.get("h2d_s"),
                           "pileup_compute_s": pileup.get("compute_s")})
    median = {mode: float(np.median([r["total_s"] for r in rs]))
              for mode, rs in runs.items()}
    report["fresh"] = runs
    print(f"[fresh] the CLI in a process of its own a run, 6 runs in "
          f"{time.perf_counter() - t:.1f} s, every run's artifacts "
          f"byte-identical to off's; median totals {json.dumps(median)}: "
          f"auto {median['auto'] / min(median['off'], median['on']):.3f} x "
          f"the faster; runs {json.dumps(runs)}", flush=True)


def phase_pileup_split(report: dict, data: str) -> None:
    """The device pileup's host side on the smoke store, piece by piece:
    the op table, the host packers the route used to run (their bytes held
    against the payload now packed on the card), the grouped launch twice
    (first use in [pipeline on]; these are steady), and the at-site pass
    on one thread against the pool."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from duet_tpu_torch.io.fasta import FastaFile
    from duet_tpu_torch.models.snp_caller import (_payload_on_device,
                                                  call_snps_for_store)
    from duet_tpu_torch.models.snp_caller_host import (SnpCallConfig,
                                                       _at_site_obs,
                                                       _nibble_pack,
                                                       _pack_codes, _pow2,
                                                       match_op_table)
    from duet_tpu_torch.utils import devcost

    store = report["store"]
    fa = FastaFile(os.path.join(data, "ref.fa"))
    codes = {c: fa.fetch_codes(c) for c in store.contigs}
    cfg = SnpCallConfig(device=True)
    dev = torch.device("cuda")
    t = time.perf_counter()
    lens = [match_op_table(cr, cfg.min_mapq)[2]
            for cr in store.contigs.values()]
    op_s = time.perf_counter() - t
    reads = [(cr.seq, cr.qual) for cr in store.contigs.values()]
    n_bases = sum(len(s) for s, _ in reads)
    ref = np.concatenate(list(codes.values()))
    Lw = _pow2(len(ref))
    ns_pad = max(_pow2(n_bases), _pow2(int(sum(int(x.sum()) for x in lens))),
                 2)
    t = time.perf_counter()
    packed = np.concatenate([_pack_codes(s, q, cfg.min_base_qual)
                             for s, q in reads])
    host = np.zeros(ns_pad // 2 + Lw, np.uint8)
    _nibble_pack(packed, host)
    host[ns_pad // 2:] = 4
    host[ns_pad // 2:ns_pad // 2 + len(ref)] = ref
    pack_s = time.perf_counter() - t
    t = time.perf_counter()
    payload = _payload_on_device(reads, ref, ns_pad, Lw, cfg.min_base_qual,
                                 dev)
    torch.cuda.synchronize()
    payload_s = time.perf_counter() - t
    if not np.array_equal(payload.cpu().numpy(), host):
        raise AssertionError("the payload packed on the card differs from "
                             "the host packers' bytes")
    runs = []
    for _ in range(2):
        devcost.reset()
        t = time.perf_counter()
        snps, obs = call_snps_for_store(store, codes, cfg, threads=4,
                                        device=dev)
        wall = time.perf_counter() - t
        runs.append({"wall_s": round(wall, 4),
                     **devcost.snapshot()["snp_pileup"]})
    t = time.perf_counter()
    serial = [_at_site_obs(cr, cfg, snps[c].pos)
              for c, cr in store.contigs.items()]
    serial_s = time.perf_counter() - t
    t = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        pooled = list(ex.map(lambda c: _at_site_obs(store.contigs[c], cfg,
                                                    snps[c].pos),
                             store.contigs))
    pool_s = time.perf_counter() - t
    for a, b, c in zip(serial, pooled, obs.values()):
        for x, y, z in zip(a, b, c):
            if not (np.array_equal(x, y) and np.array_equal(x, z)):
                raise AssertionError("the at-site passes differ")
    first = report["pipeline_on"]["device_cost"]["snp_pileup"]
    kernels = {k: round(report[k]["ms"] / 1e3, 6)
               for k in PILEUP_KERNELS}
    print(f"[pileup split] smoke store, {n_bases} bases: the kernels' s "
          f"at this window {json.dumps(kernels)} ([pileup kernel]) beside "
          f"the upload's h2d_s {runs[-1]['h2d_s']}; match_op_table "
          f"{op_s:.4f} s; host packers (_pack_codes + _nibble_pack, the "
          f"route's host work before) {pack_s:.4f} s against the payload "
          f"packed on the card {payload_s:.4f} s (bytes equal); "
          f"call_snps_for_store on the card, first use in [pipeline on] "
          f"{json.dumps(first)}, then {json.dumps(runs)}; at-site pass "
          f"serial {serial_s:.4f} s, pool of 4 {pool_s:.4f} s", flush=True)


def phase_stream(report: dict, data: str, work: str) -> None:
    """--stream under on: contig-major, native ingest, the batched score
    kernel launched per contig, byte-identical to the batch run."""
    _reset_launches()
    t = time.perf_counter()
    metrics = _run_cli(data, os.path.join(work, "stream"), "on", "--stream")
    wall = time.perf_counter() - t
    counts = _launches()
    _require_launches(counts, ["haplotag_score"], "the streaming pipeline")
    _require_launches(counts, PILEUP_KERNELS, "the streaming pipeline")
    _require_launches(counts, ["bgzf_inflate"], "the streaming pipeline")
    if metrics["ingest_backend"] != "native":
        raise AssertionError(f"--stream ingested with "
                             f"{metrics['ingest_backend']}, not native")
    _all_on_device(metrics, "--stream")
    n = _compare_artifacts(os.path.join(work, "stream"),
                           os.path.join(work, "on"))
    batch = report["pipeline_on"]
    report["stream_launches"] = counts["haplotag_score"]
    print(f"[stream] {n} artifacts byte-identical to the batch run; ingest "
          f"native; haplotag_score launches {counts['haplotag_score']} (batch "
          f"{report['launches']}); wall {wall:.2f} s, total "
          f"{metrics['total_s']} s (batch {batch['total_s']} s); stages "
          f"{json.dumps(metrics['stages'])}; stage_peak_rss_mb "
          f"{json.dumps(metrics['stage_peak_rss_mb'])}, peak_rss_mb "
          f"{metrics['peak_rss_mb']} (batch peak_rss_mb "
          f"{batch['peak_rss_mb']}; both this process's high-water mark); "
          f"device_cost haplotag "
          f"{json.dumps(metrics['device_cost']['haplotag'])}", flush=True)


def phase_resume(report: dict, data: str, work: str) -> None:
    """--resume on a copy of the batch run's calling stages: the pileup is
    loaded, the SV calls kept, the phasing rerun on the card."""
    from duet_tpu_torch.ops import haplotag_kernel

    out = os.path.join(work, "resume")
    for d in ("snp_calling", "sv_calling"):
        shutil.copytree(os.path.join(work, "on", d), os.path.join(out, d))
    _reset_launches()
    metrics = _run_cli(data, out, "on", "--resume")
    counts = dict(haplotag_kernel.LAUNCHES)
    _require_launches(counts, ["haplotag_score"], "the resumed pipeline")
    n = _compare_artifacts(out, os.path.join(work, "on"))
    with open(os.path.join(out, "run_duet.log")) as f:
        log = f.read()
    if "resume: loading" not in log or "resume: keeping" not in log:
        raise AssertionError("--resume reran a calling stage")
    print(f"[resume] {n} artifacts byte-identical to the batch run; "
          f"haplotag_score launches {counts['haplotag_score']}; total "
          f"{metrics['total_s']} s, stages {json.dumps(metrics['stages'])}",
          flush=True)


def phase_phase_only(report: dict, work: str) -> None:
    """--phase-only from the batch run's variants.vcf and haplotag tables."""
    from duet_tpu_torch.cli import main as cli_main

    on = os.path.join(work, "on")
    out = os.path.join(work, "phase_only")
    shutil.copytree(os.path.join(on, "sv_calling"),
                    os.path.join(out, "sv_calling"))
    os.makedirs(os.path.join(out, "snp_phasing"))
    tables = [n for n in os.listdir(os.path.join(on, "snp_phasing"))
              if n.endswith(".haplotags.tsv")]
    for name in tables:
        shutil.copy(os.path.join(on, "snp_phasing", name),
                    os.path.join(out, "snp_phasing"))
    t = time.perf_counter()
    rc = cli_main(["", "", out, "--phase-only", "--device-stages", "on"])
    wall = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"duet-tpu-torch --phase-only exited {rc}")
    if _read(os.path.join(out, "phased_sv.vcf")) != \
            _read(os.path.join(on, "phased_sv.vcf")):
        raise AssertionError("--phase-only wrote another phased_sv.vcf")
    print(f"[phase-only] phased_sv.vcf byte-identical to the batch run's, "
          f"from variants.vcf and {len(tables)} haplotag tables, in "
          f"{wall:.2f} s", flush=True)


def _threads_default() -> int:
    from duet_tpu_torch.cli import build_parser

    return build_parser().get_default("threads")


def phase_flags(report: dict, data: str, work: str) -> None:
    """--snp-model nn --haplotag-bam under on and under off: the same
    artifacts, the per-contig haplotagged BAMs and their indexes included;
    each mode's snp_phasing beside its run without --haplotag-bam."""
    base = ("--snp-model", "nn")
    flags = (*base, "--haplotag-bam")
    _reset_launches()
    on = _run_cli(data, os.path.join(work, "flags_on"), "on", *flags)
    counts = _launches()
    _require_launches(counts, ["haplotag_score", *SNP_FEATURE_KERNELS],
                      "--snp-model nn under on")
    report["snp_feature_launches"] = sum(counts[k]
                                         for k in SNP_FEATURE_KERNELS)
    before = _launches()
    off = _run_cli(data, os.path.join(work, "flags_off"), "off", *flags)
    if _launches() != before:
        raise AssertionError("--device-stages off launched a kernel")
    if on["backends"]["snp_pileup"] != "nn" or \
            off["backends"]["snp_pileup"] != "nn":
        raise AssertionError("--snp-model nn did not call with the network")
    bams = sorted(n for n in os.listdir(os.path.join(work, "flags_on",
                                                     "snp_phasing"))
                  if n.endswith(".bam"))
    if not bams:
        raise AssertionError("--haplotag-bam wrote no BAM")
    n = _compare_artifacts(os.path.join(work, "flags_on"),
                           os.path.join(work, "flags_off"))
    # the same modes without the flag, for the flag's cost in snp_phasing
    plain = {mode: _run_cli(data, os.path.join(work, f"nn_{mode}"), mode,
                            *base)["stages"]["snp_phasing"]
             for mode in ("on", "off")}
    cost = {mode: {"with": m["stages"]["snp_phasing"],
                   "without": plain[mode],
                   "flag_s": round(m["stages"]["snp_phasing"] - plain[mode],
                                   4)}
            for mode, m in (("on", on), ("off", off))}
    report["flags_cost"] = cost
    print(f"[flags] {' '.join(flags)}: {n} artifacts byte-identical between "
          f"on and off, BAMs {bams} included; backends on "
          f"{json.dumps(on['backends'])}; haplotag_score launches "
          f"{counts['haplotag_score']}, the SNP feature kernels' "
          f"{json.dumps({k: counts[k] for k in SNP_FEATURE_KERNELS})}; "
          f"snp_phasing s with and without "
          f"--haplotag-bam {json.dumps(cost)} (host cores "
          f"{os.cpu_count()}, affinity {len(os.sched_getaffinity(0))}, -t "
          f"{_threads_default()}); total on {on['total_s']} s, stages "
          f"{json.dumps(on['stages'])}; off {off['total_s']} s, stages "
          f"{json.dumps(off['stages'])}", flush=True)


def _per_read_bam(path: str, cr, haps: dict, lengths: dict) -> None:
    """The haplotagged BAM as the writer wrote it before the column-wise
    encoder: one BamRead a read through BamWriter, then the index read
    back from the file (build_bai).  Kept here to time it beside the
    writer the pipeline runs."""
    from duet_tpu_torch.io.bam import (
        BamHeader,
        BamRead,
        BamWriter,
        write_bam_index,
    )

    length = lengths.get(cr.contig, 0)
    header = BamHeader(
        f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{cr.contig}\tLN:{length}\n",
        [cr.contig], [length])
    with BamWriter(path, header) as w:
        for i in range(cr.n):
            t = haps.get(cr.names[i])
            tags = {} if t is None else {"HP": t[0], "PC": t[2], "PS": t[1]}
            flag = (0x10 if cr.strand[i] else 0) | \
                (0x800 if cr.supp[i] else 0)
            c0, c1 = cr.cigar_off[i], cr.cigar_off[i + 1]
            cigar = np.stack([cr.cigar_ops[c0:c1].astype(np.int32),
                              cr.cigar_lens[c0:c1]], axis=1)
            s0, s1 = cr.seq_off[i], cr.seq_off[i + 1]
            w.write(BamRead(cr.names[i], flag, 0, int(cr.starts[i]),
                            int(cr.mapq[i]), cigar, cr.seq[s0:s1],
                            cr.qual[s0:s1], tags))
    write_bam_index(path)


def phase_haplotag_bam(report: dict, work: str) -> None:
    """The --haplotag-bam writer on each smoke contig, with the tags of
    [flags]'s run under on: encode, compress and index seconds at -t's
    default, at one thread and on every core, each BAM and .bai equal to
    that run's; and the per-read writer with its re-read index on the
    first contig."""
    from duet_tpu_torch.pipeline import _write_haplotag_bam, read_haplotag_table

    store = report["store"]
    src = os.path.join(work, "flags_on", "snp_phasing")
    out = os.path.join(work, "haplotag_bam")
    os.makedirs(out)
    threads = min(_threads_default(), os.cpu_count() or 1)
    rows = {}
    for contig, cr in store.contigs.items():
        haps = read_haplotag_table(os.path.join(src,
                                                f"{contig}.haplotags.tsv"))
        row = {"reads": cr.n, "tagged": len(haps)}
        for n in sorted({threads, 1, os.cpu_count() or 1}):
            path = os.path.join(out, f"{contig}.t{n}.bam")
            t = time.perf_counter()
            split = _write_haplotag_bam(path, cr, haps, store.contig_lengths,
                                        threads=n)
            split["wall_s"] = time.perf_counter() - t
            for ext in ("", ".bai"):
                if _read(path + ext) != _read(os.path.join(
                        src, f"{contig}.bam{ext}")):
                    raise AssertionError(f"{contig}.bam{ext} at {n} threads "
                                         "differs from the pipeline's")
            row[f"threads_{n}"] = {k: round(v, 4) for k, v in split.items()
                                   if k != "bytes"}
            row["mb"] = round(split["bytes"] / 1e6, 2)
        rows[contig] = row
    first = next(iter(store.contigs))
    path = os.path.join(out, f"{first}.per_read.bam")
    t = time.perf_counter()
    _per_read_bam(path, store.contigs[first], read_haplotag_table(
        os.path.join(src, f"{first}.haplotags.tsv")), store.contig_lengths)
    per_read_s = time.perf_counter() - t
    for ext in ("", ".bai"):
        if _read(path + ext) != _read(os.path.join(src, f"{first}.bam{ext}")):
            raise AssertionError(f"the per-read writer's {first}.bam{ext} "
                                 "differs")
    report["haplotag_bam"] = rows
    print(f"[haplotag bam] -t {threads} on {os.cpu_count()} cores, BAM and "
          f".bai equal to [flags]'s at every thread count; per contig "
          f"{json.dumps(rows)}; the per-read writer and re-read index on "
          f"{first}: {per_read_s:.3f} s, the same bytes", flush=True)


def phase_bench(report: dict) -> None:
    """`python -m duet_tpu_torch.bench` (kernel + e2e auto + e2e on), in
    process; it must go through the fused kernels and print one JSON
    line, last."""
    from duet_tpu_torch import bench
    from duet_tpu_torch.ops import haplotag_kernel

    _reset_launches()
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


def _smoke_signatures(store):
    """(contig, svtype, pos, length, read_idx) of every SV type of every
    contig: the CIGAR and split-read signatures the SV caller clusters."""
    from duet_tpu_torch.models.sv_caller_host import (
        SvCallConfig,
        contig_tables,
        extract_signatures,
        extract_split_signatures,
    )

    cfg = SvCallConfig()
    for contig, cr in store.contigs.items():
        cig = extract_signatures(cr, cfg)
        spl = extract_split_signatures(cr, cfg, contig_tables(cr, cfg))
        svtype = np.concatenate([cig.svtype, spl.svtype])
        pos = np.concatenate([cig.pos, spl.pos])
        length = np.concatenate([cig.length, spl.length])
        reads = np.concatenate([cig.read_idx, spl.read_idx])
        for t in range(4):
            m = svtype == t
            yield contig, t, pos[m], length[m], reads[m]


def _mesh_cli(data: str, work: str, name: str, want: dict,
              *flags: str) -> str:
    """One CLI run under a mesh: byte-identical to the batch run, with its
    pileup, clustering and scoring on the mesh; returns its summary."""
    _reset_launches()
    t = time.perf_counter()
    metrics = _run_cli(data, os.path.join(work, name), "on", *flags)
    wall = time.perf_counter() - t
    counts = _launches()
    _require_launches(counts, PILEUP_KERNELS, " ".join(flags))
    n = _compare_artifacts(os.path.join(work, name), os.path.join(work, "on"))
    off_mesh = {s: metrics["backends"][s] for s in
                ("snp_pileup", "sv_cluster", "haplotag")
                if metrics["backends"][s] != "mesh"}
    if off_mesh:
        raise AssertionError(f"{' '.join(flags)}: not on the mesh: {off_mesh}")
    if "--stream" not in flags and metrics.get("mesh") != want:
        raise AssertionError(f"{' '.join(flags)}: metrics mesh "
                             f"{metrics.get('mesh')}, expected {want}")
    return (f"{' '.join(flags)}: {n} artifacts byte-identical, wall "
            f"{wall:.2f} s, total {metrics['total_s']} s, stages "
            f"{json.dumps(metrics['stages'])}, backends "
            f"{json.dumps(metrics['backends'])}, hand-kernel launches "
            f"{sum(counts.values())}")


def phase_mesh(report: dict, data: str, work: str) -> None:
    """The mesh's sharded functions on logical shards of card 0 against
    their single-device and host twins, then the CLI under --mesh."""
    import torch

    from duet_tpu_torch.io.fasta import FastaFile
    from duet_tpu_torch.io.native_ingest import load_read_store_native
    from duet_tpu_torch.models.snp_caller import call_contig_snps
    from duet_tpu_torch.models.snp_caller_host import SnpCallConfig
    from duet_tpu_torch.models.snp_phaser import phase_contig
    from duet_tpu_torch.models.sv_caller_host import SvCallConfig
    from duet_tpu_torch.ops.cluster import GAP, cluster_host
    from duet_tpu_torch.ops.haplotag import phase_and_tag
    from duet_tpu_torch.parallel import (cluster_sharded, make_mesh,
                                         phase_and_tag_sharded)
    from duet_tpu_torch.parallel.shard_pileup import call_snps_sharded
    from duet_tpu_torch.utils import dispatch

    t0 = time.perf_counter()
    card = torch.device("cuda", 0)
    keys = ("hap", "pc", "best_block", "phase")
    a, w, _, p, oh = _cuda(*bench_inputs())
    timing = {}
    for dp, sp in ((2, 2), (1, 4)):
        mesh = make_mesh(dp, sp, [card] * 4)
        for sweeps in (0, 2):
            got = phase_and_tag_sharded(mesh, a, w, p, oh, sweeps)
            want = phase_and_tag(a, w, p, oh, sweeps)
            _require_equal(got, [want[k] for k in keys], keys,
                           f"phase_and_tag_sharded {dp}x{sp} sweeps {sweeps}")
        torch.cuda.synchronize()
        t = time.perf_counter()
        phase_and_tag_sharded(mesh, a, w, p, oh, 2)
        torch.cuda.synchronize()
        timing[f"{dp}x{sp}"] = time.perf_counter() - t

    mesh14 = make_mesh(1, 4, [card] * 4)
    store = load_read_store_native(os.path.join(data, "reads.bam"),
                                   n_threads=min(4, os.cpu_count() or 1))
    cfg = SvCallConfig()
    n_sigs = n_clusters = 0
    for contig, svtype, pos, length, reads in _smoke_signatures(store):
        max_dist = cfg.max_dist_ins if svtype == 0 else cfg.max_dist_del
        args = (pos, length, reads, GAP, max_dist, 9, 10)
        got, want = cluster_sharded(mesh14, *args), cluster_host(*args)
        for name, g, x in zip(("call_pos", "call_len", "support", "count",
                               "seg"), got, want):
            if not np.array_equal(g, x):
                raise AssertionError(f"cluster_sharded != cluster_host on "
                                     f"{contig} type {svtype}: {name}")
        n_sigs += len(pos)
        n_clusters += len(got[0])

    ref = FastaFile(os.path.join(data, "ref.fa"))
    snp_cfg = SnpCallConfig(model="counts")
    n_sites = 0
    called = {}
    _reset_launches()
    for contig, cr in store.contigs.items():
        codes = ref.fetch_codes(contig)
        got = call_snps_sharded(mesh14, contig, cr, codes, snp_cfg)
        want, obs = call_contig_snps(contig, cr, codes, snp_cfg)
        for f in ("pos", "alt_code", "is_het", "depth", "alt_count"):
            if not np.array_equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"call_snps_sharded != host caller on "
                                     f"{contig}: {f}")
        n_sites += len(got.pos)
        called[contig] = (cr, want, obs)
    pileup_launches = _launches()
    _require_launches(pileup_launches, PILEUP_KERNELS, "call_snps_sharded")

    # the pipeline's mesh scorer (_haplotag_device's chunks of 256 * dp
    # rows, S_w a multiple of sp) on a 2 x 2 mesh of card 0, against the
    # single-device scorer (the hand kernel) on the same contig
    mesh22 = make_mesh(2, 2, [card] * 4)
    mesh_chunks = n_tagged = 0
    for contig, (cr, snps, obs) in called.items():
        single = phase_contig(cr, snps, snp_cfg, use_device=True, obs=obs,
                              device=card)
        before = dispatch.snapshot().get("haplotag", {}).get("mesh", 0)
        sharded = phase_contig(cr, snps, snp_cfg, use_device=True, obs=obs,
                               mesh=mesh22)
        mesh_chunks += (dispatch.snapshot().get("haplotag", {}).get("mesh", 0)
                        - before)
        for f in ("phase", "block_id", "block_ps", "read_hap", "read_ps",
                  "read_pc"):
            if not np.array_equal(getattr(sharded, f), getattr(single, f)):
                raise AssertionError(f"phase_contig on the 2x2 mesh != the "
                                     f"single-device tagging on {contig}: "
                                     f"{f}")
        n_tagged += int((sharded.read_hap != 0).sum())
    if mesh_chunks == 0 or n_tagged == 0:
        raise AssertionError(f"phase_contig on the 2x2 mesh scored "
                             f"{mesh_chunks} chunks, tagged {n_tagged} reads")
    funcs_s = time.perf_counter() - t0

    n = torch.cuda.device_count()
    auto_sp = 2 if n % 2 == 0 and n >= 4 else 1      # the pipeline's rule
    runs = [_mesh_cli(data, work, "mesh11", {"dp": 1, "sp": 1},
                      "--mesh", "1,1"),
            _mesh_cli(data, work, "mesh_auto",
                      {"dp": n // auto_sp, "sp": auto_sp}, "--mesh", "auto"),
            _mesh_cli(data, work, "mesh_stream", {"dp": 1, "sp": 1},
                      "--stream", "--mesh", "1,1")]
    if n > 1:
        runs.append(_mesh_cli(data, work, "mesh_n1", {"dp": n, "sp": 1},
                              "--mesh", f"{n},1"))
    print(f"[mesh] logical shards of {report['card']}: phase_and_tag_sharded "
          f"== phase_and_tag ({TOLERANCE} and int8 phase) at R={a.shape[0]}, "
          f"S={a.shape[1]}, meshes 2x2 and 1x4, sweeps 0 and 2 (one sweeps-2 "
          f"call: {json.dumps({k: round(v, 4) for k, v in timing.items()})} "
          f"s); cluster_sharded (1x4) == cluster_host on {n_sigs} smoke "
          f"signatures ({n_clusters} clusters, 2 contigs x 4 types); "
          f"call_snps_sharded (1x4) == the host caller on "
          f"{len(store.contigs)} contigs ({n_sites} sites; pileup kernel "
          f"launches {pileup_launches['pileup_count']} / "
          f"{pileup_launches['pileup_call']}); phase_contig "
          f"on a 2x2 mesh == the single-device tagging on "
          f"{len(called)} contigs ({mesh_chunks} mesh chunks, {n_tagged} "
          f"reads tagged); functions "
          f"{funcs_s:.1f} s; {torch.cuda.device_count()} card(s) visible; "
          f"CLI: {' | '.join(runs)}", flush=True)


def _device_busy(events: list) -> tuple[float, float]:
    """(union of the GPU kernel, memcpy and memset intervals, the traced
    window), in microseconds, from a Chrome trace's events."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi <= end:
            continue
        busy += hi - max(lo, end)
        end = hi
    timed = [e for e in events if "ts" in e and "dur" in e]
    window = max(e["ts"] + e["dur"] for e in timed) - \
        min(e["ts"] for e in timed)
    return busy, window


def phase_profile(report: dict, data: str, work: str) -> None:
    """--profile under on: the artifacts of the batch run, a trace that
    loads as JSON and holds CUDA kernel events, and the device idle share
    of the run."""
    out = os.path.join(work, "profile")
    _reset_launches()
    t = time.perf_counter()
    metrics = _run_cli(data, out, "on", "--profile")
    wall = time.perf_counter() - t
    counts = _launches()
    _require_launches(counts, ["haplotag_score"], "the profiled pipeline")
    _require_launches(counts, PILEUP_KERNELS, "the profiled pipeline")
    n = _compare_artifacts(out, os.path.join(work, "on"))
    path = os.path.join(out, "profile", "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError("the --profile trace holds no CUDA kernel event")
    names = {e["name"] for e in kernels}
    for kernel in ("haplotag_score_kernel", "tile_count", "compact_sites"):
        if not any(kernel in k for k in names):
            raise AssertionError(f"{kernel} is not in the trace: "
                                 f"{sorted(names)[:20]}")
    busy, window = _device_busy(events)
    report["profile"] = {"idle_share": 1.0 - busy / window, "wall_s": wall,
                         "busy_ms": busy / 1e3, "window_ms": window / 1e3}
    print(f"[profile] --profile under on: {n} artifacts byte-identical to the "
          f"batch run; trace {os.path.getsize(path)} bytes, {len(events)} "
          f"events, {len(kernels)} kernel events of {len(names)} kernels; "
          f"device busy {busy / 1e3:.2f} ms of a {window / 1e3:.2f} ms traced "
          f"window: idle share {report['profile']['idle_share']:.6f}; "
          f"haplotag_score launches {counts['haplotag_score']}, pileup "
          f"{counts['pileup_count']} / {counts['pileup_call']}; wall "
          f"{wall:.2f} s (unprofiled [pipeline on] {report['pipeline_on_wall']:.2f}"
          f" s), total {metrics['total_s']} s (unprofiled "
          f"{report['pipeline_on']['total_s']} s), stages "
          f"{json.dumps(metrics['stages'])} on {report['card']}", flush=True)


# run in each process of [multiprocess]: the CLI, then the launch counts
_CLI_WITH_LAUNCHES = (
    "import json, sys\n"
    "from duet_tpu_torch.cli import main\n"
    "from duet_tpu_torch.ops import bgzf_inflate, haplotag_kernel, "
    "pileup_kernel\n"
    "rc = main(sys.argv[1:])\n"
    "print('LAUNCHES ' + json.dumps({**haplotag_kernel.LAUNCHES,\n"
    "                                **pileup_kernel.LAUNCHES,\n"
    "                                **bgzf_inflate.launches()}), "
    "flush=True)\n"
    "sys.exit(rc)\n")


def phase_multiprocess(report: dict, data: str, work: str) -> None:
    """Two processes on card 0, joined by torch.distributed (gloo) at a
    local coordinator: each ingests and calls the contig it owns and
    scores it with haplotag_score; process 0 merges the parts."""
    import socket

    out = os.path.join(work, "multiprocess")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{sock.getsockname()[1]}"
    repo = os.path.dirname(os.path.abspath(__file__))
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CLI_WITH_LAUNCHES,
         os.path.join(data, "reads.bam"), os.path.join(data, "ref.fa"), out,
         "--device-stages", "on", "--coordinator", addr,
         "--num-processes", "2", "--process-id", str(pid)],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in (0, 1)]
    try:
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t
    launches = []
    for pid, (p, (stdout, stderr)) in enumerate(zip(procs, results)):
        if p.returncode != 0:
            raise AssertionError(f"process {pid} exited {p.returncode}: "
                                 f"{stderr[-3000:]}")
        line = [ln for ln in stdout.splitlines() if ln.startswith("LAUNCHES ")]
        counts = json.loads(line[-1].split(" ", 1)[1])
        _require_launches(counts, ["haplotag_score"], f"process {pid}")
        _require_launches(counts, PILEUP_KERNELS, f"process {pid}")
        _require_launches(counts, ["bgzf_inflate"], f"process {pid}")
        launches.append({k: counts[k] for k in ("haplotag_score",
                                                "pileup_count",
                                                "pileup_call",
                                                "bgzf_inflate")})
    for name in ("snp_calling/pileup.vcf.gz", "sv_calling/variants.vcf",
                 "phased_sv.vcf"):
        if _read(os.path.join(out, name)) != \
                _read(os.path.join(work, "on", name)):
            raise AssertionError(f"multi-process {name} differs from the "
                                 f"batch run's")
    metrics = []
    for name in ("metrics.json", "metrics.p1.json"):
        with open(os.path.join(out, name)) as f:
            metrics.append(json.load(f))
    report["multiprocess_launches"] = launches
    print(f"[multiprocess] 2 processes at {addr} (gloo) on {report['card']}: "
          f"pileup.vcf.gz, variants.vcf and phased_sv.vcf byte-identical to "
          f"the batch run; launches per process {json.dumps(launches)}; "
          f"wall {wall:.2f} s; process totals "
          f"{[m['total_s'] for m in metrics]} s, contigs "
          f"{[m['counts']['contigs'] for m in metrics]}, stages "
          f"{json.dumps([m['stages'] for m in metrics])}", flush=True)


TRAIN_STEPS = 1200


def phase_train(report: dict, work: str) -> None:
    """``nn_snp.train`` on the card at full size: duet_tpu's default corpus
    (4 seeds x 7 coverages of a 300 kb contig), 1200 steps, batch 16384,
    the model's full 51-64-64-3 width.  The weights go to the work
    directory; the shipped weights stay untouched."""
    import hashlib

    import torch

    from duet_tpu_torch.io import native_ingest
    from duet_tpu_torch.models import nn_snp
    from duet_tpu_torch.utils import spans

    def digest(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    shipped = digest(nn_snp.DEFAULT_WEIGHTS)
    out = os.path.join(work, "nn_snp_trained.npz")
    lines, stamps = [], {}

    def log(msg: str) -> None:
        # train syncs the card for each loss it logs (float(loss)), so the
        # clock between two logged steps spans finished steps
        stamps[msg.split(":")[0]] = time.perf_counter()
        lines.append(msg)

    spans.reset("ingest.")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    nn_snp.train(out, steps=TRAIN_STEPS, device=torch.device("cuda"),
                 log=log)
    wall = time.perf_counter() - t0
    reader = "native" if native_ingest.decode_stats() else "python"
    if digest(nn_snp.DEFAULT_WEIGHTS) != shipped:
        raise AssertionError("training changed the shipped weights")
    n = int(lines[0].split()[2])
    last = f"step {TRAIN_STEPS - 1}"
    ms_step = (stamps[last] - stamps["step 100"]) / (TRAIN_STEPS - 101) * 1e3
    losses = [float(m.rsplit(" ", 1)[1]) for m in lines
              if m.startswith("step ")]
    recall = {m.split("[")[1].split("]")[0]: float(m.rsplit(" ", 1)[1])
              for m in lines if m.startswith("train recall[")}
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the training loss did not fall: {losses}")
    report["train"] = {"weights": out, "ms_step": ms_step}
    print(f"[train] nn_snp.train on cuda: {lines[0]}; reader {reader}; "
          f"corpus built in {stamps['training set'] - t0:.1f} s; "
          f"{TRAIN_STEPS} steps of batch {min(16384, n)}, "
          f"{ms_step:.4f} ms a step (card synced, steps 101-"
          f"{TRAIN_STEPS - 1}); loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"train recall {json.dumps(recall)}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; wall "
          f"{wall:.1f} s on {report['card']}", flush=True)


def _grid_counts(coverage: float, sub_error: float, seed: int):
    """snp_grid.run_cell's dataset and pileup: (counts, ref codes, truth
    arrays) of its 250 kb contig."""
    from duet_tpu_torch.io.fasta import FastaFile
    from duet_tpu_torch.io.readstore import load_read_store
    from duet_tpu_torch.models.snp_caller_host import (
        SnpCallConfig, count_alleles, pileup_observations)
    from duet_tpu_torch.sim import SimConfig, simulate_dataset

    tmp = tempfile.mkdtemp(prefix="snp_grid_")
    try:
        truth = simulate_dataset(tmp, SimConfig(
            contigs={"chrG": 250_000}, seed=seed, coverage=coverage,
            sub_error=sub_error, sv_count_per_mb=0.0))
        cr = load_read_store(os.path.join(tmp, "reads.bam")).contigs["chrG"]
        codes = FastaFile(os.path.join(tmp, "ref.fa")).fetch_codes("chrG")
        cfg = SnpCallConfig()
        obs = pileup_observations(cr, cfg)
        counts = count_alleles(obs[0], obs[1], obs[2], len(codes),
                               cfg.min_base_qual)
        return counts, codes, (truth.snp_pos["chrG"], truth.snp_alt["chrG"],
                               truth.snp_gt["chrG"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


GRID_CELLS = [(6.0, 0.02, 101), (10.0, 0.02, 101)]   # snp_grid --quick


def phase_snp_grid(report: dict) -> None:
    """The newly trained weights against the shipped ones on snp_grid
    --quick's cells, both on the card; fails if the trained F1 falls more
    than 0.02 below the shipped F1 in a cell.  The shipped weights' calls
    on the card equal their calls on the CPU, and snp_grid.run_cell on the
    card scores them as this phase does."""
    import torch

    from duet_tpu_torch.models.nn_snp import load_model, nn_call_snps
    from duet_tpu_torch.tools import snp_grid

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    models = {"trained": load_model(report["train"]["weights"], cuda),
              "shipped": load_model(device=cuda)}
    rows = []
    for cov, err, seed in GRID_CELLS:
        counts, codes, truth = _grid_counts(cov, err, seed)
        row = {"coverage": cov, "sub_error": err, "seed": seed}
        for name, model in models.items():
            snps = nn_call_snps("chrG", counts, codes, model=model,
                                device=cuda)
            row[name] = snp_grid.score(snps, *truth)
            if name == "shipped":
                host = nn_call_snps("chrG", counts, codes, device=cpu)
                for f in ("pos", "alt_code", "is_het"):
                    if not np.array_equal(getattr(snps, f), getattr(host, f)):
                        raise AssertionError(f"shipped weights: {f} differs "
                                             f"between card and CPU")
        cell = snp_grid.run_cell(cov, err, seed, device=cuda)
        if cell["nn"] != row["shipped"]:
            raise AssertionError(f"snp_grid.run_cell scored {cell['nn']}, "
                                 f"this phase {row['shipped']}")
        row["counts"] = cell["counts"]
        if row["trained"]["f1"] < row["shipped"]["f1"] - 0.02:
            raise AssertionError(f"trained F1 {row['trained']['f1']} is more "
                                 f"than 0.02 below shipped "
                                 f"{row['shipped']['f1']} at {cov}x")
        rows.append(row)
    report["snp_grid"] = rows
    print(f"[snp_grid] trained vs shipped weights on the card, snp_grid "
          f"--quick cells; the shipped weights' calls equal on card and "
          f"CPU; rows {json.dumps(rows)}", flush=True)


def phase_crossover(report: dict) -> None:
    """tools.haplotag_crossover on cuda, as its CLI runs it: host, dense
    (the hand kernel haplotag_score) and sparse scorers at 50k, 200k and
    800k nnz, then the multi-contig launch; every output equal to the
    host scorer's (the tool asserts it)."""
    from duet_tpu_torch.ops import haplotag_kernel
    from duet_tpu_torch.tools import haplotag_crossover

    docs = []
    for argv in (["--sizes", "50,200,800"],
                 ["--multi", "2,4,8", "--sizes", "512"]):
        _reset_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = haplotag_crossover.main(argv)
        if rc != 0:
            raise AssertionError(f"haplotag_crossover {argv} exited {rc}")
        counts = dict(haplotag_kernel.LAUNCHES)
        docs.append(json.loads(out.getvalue().strip().splitlines()[-1]))
        if "--multi" not in argv:
            _require_launches(counts, ["haplotag_score"],
                              "haplotag_crossover's dense mode")
            report["crossover_launches"] = counts["haplotag_score"]
    report["crossover"] = docs
    split = _dense_launch_split(report)
    print(f"[crossover] haplotag_crossover --device cuda, outputs equal to "
          f"the host scorer's; haplotag_score launches "
          f"{report['crossover_launches']}; crossover nnz by mode "
          f"{json.dumps(docs[0]['crossover_nnz_by_mode'])}; rows "
          f"{json.dumps(docs[0]['rows'])}; --multi 2,4,8 --sizes 512 rows "
          f"{json.dumps(docs[1]['rows'])}; the dense route at 800k nnz, per "
          f"launch: {json.dumps(split)} on {report['card']}", flush=True)


def _dense_launch_split(report: dict) -> dict:
    """One dense scoring call at 800k nnz (after a first call), its wall
    per launch split into the device phases devcost times (upload,
    compute: the tiles built on the card and the launches, readback) and
    the host's remainder, beside the kernel alone at the pipeline shape
    ([kernel])."""
    import torch

    from duet_tpu_torch.models.snp_phaser import _haplotag_device
    from duet_tpu_torch.ops import haplotag_kernel
    from duet_tpu_torch.tools.haplotag_crossover import make_problem
    from duet_tpu_torch.utils import devcost

    dev = torch.device("cuda")
    problem = make_problem(800_000)
    _haplotag_device(*problem, mode="dense", device=dev)
    devcost.reset()
    _reset_launches()
    t = time.perf_counter()
    _haplotag_device(*problem, mode="dense", device=dev)
    wall = time.perf_counter() - t
    n = haplotag_kernel.LAUNCHES["haplotag_score"]
    cost = devcost.snapshot()["haplotag"]
    phases = cost["h2d_s"] + cost["compute_s"] + cost["d2h_s"]
    return {"launches": n, "wall_ms": wall * 1e3 / n,
            "h2d_ms": cost["h2d_s"] * 1e3 / n,
            "compute_ms": cost["compute_s"] * 1e3 / n,
            "d2h_ms": cost["d2h_s"] * 1e3 / n,
            "host_ms": (wall - phases) * 1e3 / n,
            "kernel_alone_ms": report["kernel"]["ms"]}


GATE_SIZES = ["phasing=10000,50000,800000", "sv=4000,64000",
              "decide=1000,16000", "pileup=500000,2000000"]


def phase_gates(report: dict) -> None:
    """route_crossover on the card at 2-3 sizes a stage: every stage's
    host and device routes equal, their times, and the gates these rows
    give beside the committed ones (derived from the full run's rows)."""
    from duet_tpu_torch import route_crossover
    from duet_tpu_torch.pipeline import PipelineConfig

    argv = [a for s in GATE_SIZES for a in ("--sizes", s)]
    t = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = route_crossover.main(argv)
    if rc != 0:
        raise AssertionError(f"route_crossover {argv} exited {rc}")
    doc = json.loads(out.getvalue().strip().splitlines()[-1])
    committed = PipelineConfig(bam="", reference="", output="",
                               snp_model="counts").device_size_gates()
    report["gates"] = doc
    print(f"[gates] route_crossover {' '.join(argv)} in "
          f"{time.perf_counter() - t:.1f} s, every stage's routes equal; "
          f"gates of these rows {json.dumps(doc['gates'])}; committed "
          f"{json.dumps(committed)}; rows {json.dumps(doc['rows'])} on "
          f"{doc['card']}", flush=True)


def phase_tools(report: dict, data: str, work: str) -> None:
    """The demo maker, the evaluation of the batch run against the smoke's
    truth, a merge of the batch and stream callsets, a region count and a
    one-point cluster_max_distance sweep, each through its entry point."""
    from duet_tpu_torch.eval import evaluate
    from duet_tpu_torch.sim import cli_make_demo
    from duet_tpu_torch.tools import merge, sweep, view

    def run(main, argv) -> str:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(argv)
        if rc != 0:
            raise AssertionError(f"{main.__module__} {argv} exited {rc}")
        return out.getvalue()

    demo = os.path.join(work, "demo")
    run(cli_make_demo.main, [demo])
    missing = [n for n in ("reads.bam", "reads.bam.bai", "ref.fa",
                           "ref.fa.fai", "truth.vcf")
               if not os.path.exists(os.path.join(demo, n))]
    if missing:
        raise AssertionError(f"cli_make_demo wrote no {missing}")
    truth = os.path.join(data, "truth.vcf")
    batch = os.path.join(work, "on", "phased_sv.vcf")
    scores = json.loads(run(evaluate.main, [batch, truth]))
    f1 = {k: scores[k]["f1"] for k in ("calling", "genotyping", "phasing")}
    if f1["calling"] <= 0.5:
        raise AssertionError(f"the batch run's calling F1 is {f1}")
    merged = os.path.join(work, "merged.vcf")
    run(merge.main, [batch, os.path.join(work, "stream", "phased_sv.vcf"),
                     "-o", merged, "--names", "batch", "stream"])
    with open(merged) as f:
        records = [ln for ln in f if not ln.startswith("#")]
    both = sum(";NS=2\t" in ln for ln in records)
    if not both:
        raise AssertionError("merging two identical callsets matched no "
                             "call across them")
    bam = os.path.join(data, "reads.bam")
    region = "chr1:1000000-1100000"
    n_view = int(run(view.main, ["-c", bam, region]))
    if n_view <= 0:
        raise AssertionError(f"view -c {region} counted {n_view}")
    # a region without an end on the demo's 200 kb contig: the whole
    # contig, as bounded at its length
    demo_bam = os.path.join(demo, "reads.bam")
    t = time.perf_counter()
    n_open = int(run(view.main, ["-c", demo_bam, "chr21"]))
    open_s = time.perf_counter() - t
    n_bounded = int(run(view.main, ["-c", demo_bam, "chr21:1-200000"]))
    if n_open != n_bounded or n_open <= 0:
        raise AssertionError(f"view -c chr21 counted {n_open}, the bounded "
                             f"region {n_bounded}")
    t = time.perf_counter()
    sw = json.loads(run(sweep.main, [bam, os.path.join(data, "ref.fa"),
                                     os.path.join(work, "sweep"), "-c",
                                     "0.5", "--truth", truth]))
    sweep_s = time.perf_counter() - t
    if sw["n_calls"][0] <= 0:
        raise AssertionError(f"the sweep called nothing: {sw}")
    print(f"[tools] cli_make_demo wrote {demo}; eval.evaluate of the batch "
          f"run: F1 {json.dumps(f1)}, {scores['truth_svs']} truth / "
          f"{scores['called_svs']} called SVs; merge of batch + stream: "
          f"{len(records)} records, {both} in both; view -c {region}: "
          f"{n_view} reads; view -c chr21 of the demo (no end): {n_open} "
          f"reads in {open_s:.3f} s, as chr21:1-200000; sweep -c 0.5: "
          f"{sw['n_calls'][0]} calls, calling "
          f"F1 {sw['calling_f1'][0]} in {sweep_s:.1f} s", flush=True)


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
    ("pileup_count", "duet_tpu_torch/csrc/pileup.cu",
     "duet_tpu/ops/pileup.py:124", "pileup_count"),
    ("pileup_call", "duet_tpu_torch/csrc/pileup.cu",
     "duet_tpu/ops/pileup.py:168", "pileup_call"),
    ("snp_features", "duet_tpu_torch/csrc/snp_features.cu",
     "none (numpy: duet_tpu/models/nn_snp.py candidate_sites + "
     "extract_features)", "snp_features"),
    ("bgzf_inflate", "duet_tpu_torch/csrc/bgzf_inflate.cu",
     "none (host zlib or libdeflate: native/duet_ingest.cc refill)",
     "bgzf_inflate"),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    report: dict = {}
    t0 = time.perf_counter()
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
        phase_ingest(report, data)
        phase_bgzf_inflate(report, work)
        phase_pileup_kernel(report, data)
        phase_snp_features(report)
        phase_pipeline_on(report, data, work)
        phase_pipeline_off(report, data, work)
        phase_pipeline_auto(report, data, work)
        phase_fresh(report, data, work)
        phase_pileup_split(report, data)
        phase_stream(report, data, work)
        phase_resume(report, data, work)
        phase_phase_only(report, work)
        phase_flags(report, data, work)
        phase_haplotag_bam(report, work)
        phase_bench(report)
        phase_mesh(report, data, work)
        phase_profile(report, data, work)
        phase_multiprocess(report, data, work)
        phase_train(report, work)
        phase_snp_grid(report)
        phase_crossover(report)
        phase_gates(report)
        phase_tools(report, data, work)
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
                    report["bench_launches"]["haplotag_score_shared"],
                **report["pileup_launches"],
                "snp_features": report["snp_feature_launches"],
                "bgzf_inflate": report["bgzf_launches"]}
    print(f"[wall] every phase in {time.perf_counter() - t0:.1f} s",
          flush=True)
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
