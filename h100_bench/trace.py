"""The traced samples: torch.profiler over a few whole samples, each stage
inside the ``record_function`` range ``clock.stage_clock`` opens, reduced
to the device's busy time, its heaviest operations and its idle time by
stage."""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass

from h100_bench.clock import STAGE_PREFIX

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 160   # a templated kernel's name runs to thousands


@dataclass
class Trace:
    busy_s: float
    window_s: float
    device_ops: list
    idle_gaps: list

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops, "idle_gaps": self.idle_gaps}


def device_busy(events: list) -> tuple[float, float]:
    """(union of the GPU kernel, memcpy and memset intervals, the traced
    window), in microseconds, from a Chrome trace's events.  A copy of
    ``chip_smoke.py::_device_busy``."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in DEVICE_CATS)
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


def _merged(spans):
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def idle_by_stage(events: list) -> list:
    """[stage, idle seconds] for the window's idle time on the card, split
    by the stage range the host was in ("outside stages" for the rest),
    largest first."""
    timed = [e for e in events if "ts" in e and "dur" in e]
    start = min(e["ts"] for e in timed)
    end = max(e["ts"] + e["dur"] for e in timed)
    busy = _merged((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in DEVICE_CATS)
    gaps, t = [], start
    for lo, hi in busy:
        if lo > t:
            gaps.append((t, lo))
        t = max(t, hi)
    if end > t:
        gaps.append((t, end))
    stages = [(e["ts"], e["ts"] + e["dur"], e["name"][len(STAGE_PREFIX):])
              for e in events if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(STAGE_PREFIX)]
    idle = defaultdict(float)
    for lo, hi in gaps:
        covered = 0.0
        for s_lo, s_hi, name in stages:
            overlap = min(hi, s_hi) - max(lo, s_lo)
            if overlap > 0:
                idle[name] += overlap
                covered += overlap
        idle["outside stages"] += (hi - lo) - covered
    ranked = sorted(idle.items(), key=lambda kv: -kv[1])
    return [[name, us / 1e6] for name, us in ranked[:TOP] if us > 0]


def device_ops(events: list) -> list:
    """[name, device seconds] of the operations that took most time."""
    total = defaultdict(float)
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            total[e["name"][:NAME_CHARS]] += e["dur"]
    ranked = sorted(total.items(), key=lambda kv: -kv[1])
    return [[name, us / 1e6] for name, us in ranked[:TOP]]


def summarize(events: list) -> Trace:
    busy, window = device_busy(events)
    return Trace(busy / 1e6, window / 1e6, device_ops(events),
                 idle_by_stage(events))


def traced_samples(run_one, n: int, path: str) -> Trace:
    """Run `run_one(k)` for k < n under torch.profiler (each sample's
    stages inside their ``stage:<stage>`` ranges, ``clock.stage_clock``);
    write the Chrome trace to `path` and reduce it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for k in range(n):
            run_one(k)
    prof.export_chrome_trace(path)
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"])
