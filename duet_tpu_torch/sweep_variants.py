"""Time build variants of the sweep kernel (``csrc/haplotag_sweep.cu``) on
the card: `python -m duet_tpu_torch.sweep_variants`.

Each variant is the kernel built with other values of its shape macros
(threads a CTA, the most rows a tile, ring stages, the cap on resident CTAs
an SM), one nvcc each, all started together.  Every variant is checked
``torch.equal`` to the plain version on the bench's window (R=32768,
S=4096) and the quick one (8192 x 1024), then timed on both in turns
(default build, variant, variant, default build): the median of CUDA-event
timed launches.  One line a variant with its launch shape, its times and
ptxas's registers, spills and shared memory; the last line is one JSON
object with all of it.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from duet_tpu_torch.bench import KERNEL_SHAPE, make_batch
from duet_tpu_torch.ops import cuda_build, haplotag_kernel
from duet_tpu_torch.ops.haplotag import power_sweep_votes

# (threads, rows, stages, CTAs per SM); the first is the default build
VARIANTS = [(512, 8, 2, 2), (256, 8, 2, 2), (1024, 8, 2, 1), (128, 8, 2, 2),
            (512, 4, 2, 2), (256, 4, 2, 2), (512, 4, 3, 2), (256, 4, 3, 2),
            (512, 2, 2, 2), (256, 2, 2, 2), (256, 2, 3, 3), (256, 2, 4, 2)]
MACROS = ("SW_THREADS", "SW_ROWS", "SW_STAGES", "SW_CTAS_PER_SM")


def _defines(v) -> tuple[str, ...]:
    return () if v == VARIANTS[0] else tuple(
        f"{k}={x}" for k, x in zip(MACROS, v))


def _median_ms(fn, reps: int = 20) -> float:
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


def _stream_ms(fn, reps: int = 20) -> float:
    """Device time a launch: `reps` launches back to back between two
    events, so the host's work per launch overlaps the card's."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ptxas(log: str) -> str:
    """ptxas's line for the one-pass kernel: registers, spills, smem."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "one_pass" in ln:
            rest = " ".join(x.split("info    :")[-1].strip()
                            for x in lines[i + 1:i + 4]
                            if "spill" in x or "Used" in x)
            return re.sub(r"\s+", " ", rest)
    return "not found"


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_variants: no CUDA device visible to torch",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = list(ex.map(lambda v: haplotag_kernel._sweep_library(
            _defines(v)), VARIANTS))
    windows = {}
    for label in ("full", "quick"):
        R, S, B = KERNEL_SHAPE[label]
        A, W, phase0, _ = make_batch(R, S, B, density=0.05, seed=0)
        a = torch.from_numpy(A).cuda()
        w16 = torch.from_numpy(W).to(torch.bfloat16).cuda()
        p16 = torch.from_numpy(phase0).to(torch.bfloat16).cuda()
        windows[label] = (a, w16, p16, power_sweep_votes(a, w16, p16))
    base = libs[0]
    rows = []
    for v, lib in zip(VARIANTS, libs):
        defines = _defines(v)
        name = haplotag_kernel.sweep_library_name(defines)
        row = {"threads": v[0], "rows": v[1], "stages": v[2],
               "ctas_per_sm_cap": v[3],
               "ptxas": _ptxas(cuda_build.BUILD_INFO[name]["log"])}
        for label, (a, w16, p16, want) in windows.items():
            got = haplotag_kernel.sweep_launch(lib, a, w16, p16)
            torch.cuda.synchronize()
            if not torch.equal(got.float(), want):
                raise AssertionError(f"variant {v} != plain on {label}")
            ks, ds = [], []
            for _ in range(3):
                ds.append(_median_ms(lambda: haplotag_kernel.sweep_launch(
                    base, a, w16, p16)))
                ks.append(_median_ms(lambda: haplotag_kernel.sweep_launch(
                    lib, a, w16, p16)))
                ks.append(_median_ms(lambda: haplotag_kernel.sweep_launch(
                    lib, a, w16, p16)))
                ds.append(_median_ms(lambda: haplotag_kernel.sweep_launch(
                    base, a, w16, p16)))
            row[label] = {
                "ms": float(np.median(ks)), "default_ms": float(np.median(ds)),
                "stream_ms": float(np.median([_stream_ms(
                    lambda: haplotag_kernel.sweep_launch(lib, a, w16, p16))
                    for _ in range(3)])),
                "shape": haplotag_kernel.sweep_launch_shape(*a.shape,
                                                            defines)}
        rows.append(row)
        full, quick = row["full"], row["quick"]
        print(f"[variant] threads {v[0]} rows {v[1]} stages {v[2]} CTAs/SM "
              f"cap {v[3]}: bench "
              f"{full['ms']:.4f} ms single (default {full['default_ms']:.4f})"
              f", {full['stream_ms']:.4f} ms back to back; quick "
              f"{quick['ms']:.4f} ms (default {quick['default_ms']:.4f}), "
              f"{quick['stream_ms']:.4f} ms back to back; bench shape "
              f"{full['shape']}; ptxas {row['ptxas']} on {smi}", flush=True)
    print(json.dumps({"card": smi, "variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
