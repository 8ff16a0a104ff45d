"""One registry of the program's spans and counters.

A span is a named interval of host work at a layer boundary::

    with span("snp_calling.features"):
        ...

    @span("write.pileup_vcf")
    def write_pileup_vcf(...):

It reads ``time.perf_counter`` on entering and leaving, and adds the
seconds and one call to its name.  Its parent is the innermost span open
on the same thread when it opens; the parent's ``self_s`` is its seconds
less what its child spans cover.  A span opened on a pool thread has no
parent (that thread holds no open span), and the seconds of one name are
summed over the threads that opened it, so with several threads in
flight they can exceed the wall time of the span that started the pool.

While a profiler records, a span also opens a
``torch.profiler.record_function`` range of its name, so the program's
ranges share the Chrome trace's timeline with the card's kernels and
copies; otherwise a span costs two clock reads and one locked dict update.

A counter adds a value under a name (bytes, items, or a native timer's
seconds: ``count``); ``add`` charges a span with seconds that native code
timed itself.  ``reset`` starts a run's window (or clears the names
under one prefix), ``snapshot`` reads it.  Thread-safe.

``idle_by_span`` reduces a Chrome trace of a run to the card's idle time
owned by each span name (``cli --profile``'s ``idle_by_span.json``).

Names in use (PERF.md §3): the stages ``ingest``, ``snp_calling``,
``sv_calling``, ``snp_phasing``, ``sv_phasing`` (``utils.logging.
StageTimer``), their children ``<stage>.<step>``, the artifact writers
``write.<artifact>`` and the tabix index ``index.tabix``, the device
phases ``device.<stage>.{h2d,compute,d2h}`` (``utils.devcost``); the
counters ``index.tabix.from_writer`` (a .tbi built from its writer's
offsets),
``dispatch.<stage>.<backend>`` (``utils.dispatch``),
``device.<stage>.{h2d,d2h}_bytes``, the native decode's ``ingest.*``,
the neural caller's ``snp_calling.candidates`` and the switch
correction's ``snp_phasing.{correct_rounds,switch_flips,
switch_correct_fallbacks}``.
No name begins with ``stage:``, the benchmark's own range prefix.
"""

from __future__ import annotations

import bisect
import functools
import heapq
import sys
import threading
import time
from collections import defaultdict

_lock = threading.Lock()
_spans: dict[str, dict] = {}      # name -> {"s", "self_s", "n", "max_s", "parent"}
_counters: dict[str, float] = {}
_local = threading.local()


def _profiler_enabled() -> bool:
    """Whether a torch profiler records; without torch loaded none can,
    and this module loads no torch itself (the host modules that open
    spans stay light to import)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class span:
    """Context manager of one span of `name`; ``s`` holds its seconds once
    it has closed.  As a decorator (``@span(name)``), each call of the
    function is one span of `name`."""

    __slots__ = ("name", "s", "_t", "_child", "_parent", "_range")

    def __init__(self, name: str) -> None:
        self.name = name
        self.s = 0.0

    def __enter__(self) -> "span":
        stack = _stack()
        self._parent = stack[-1] if stack else None
        stack.append(self)
        self._child = 0.0
        self._range = None
        if _profiler_enabled():
            from torch.autograd.profiler import record_function

            self._range = record_function(self.name)
            self._range.__enter__()
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = self.s = time.perf_counter() - self._t
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack().pop()
        parent = self._parent
        if parent is not None:
            parent._child += dt
        with _lock:
            e = _spans.get(self.name)
            if e is None:
                e = _spans[self.name] = {
                    "s": 0.0, "self_s": 0.0, "n": 0, "max_s": 0.0,
                    "parent": parent.name if parent is not None else None}
            e["s"] += dt
            e["self_s"] += dt - self._child
            e["n"] += 1
            if dt > e["max_s"]:
                e["max_s"] = dt

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


def add(name: str, seconds: float, n: int = 1) -> None:
    """Add `n` calls and their `seconds` to the span `name`, for work timed
    elsewhere (native code's own clocks); it has no parent, and its longest
    call is taken as `seconds` over `n`."""
    with _lock:
        e = _spans.get(name)
        if e is None:
            e = _spans[name] = {"s": 0.0, "self_s": 0.0, "n": 0,
                                "max_s": 0.0, "parent": None}
        e["s"] += seconds
        e["self_s"] += seconds
        e["n"] += n
        e["max_s"] = max(e["max_s"], seconds / max(n, 1))


def count(name: str, value: float = 1) -> None:
    """Add `value` to the counter `name`."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


def reset(prefix: str = "") -> None:
    """Start a fresh window: forget every span and counter whose name
    begins with `prefix` (all of them by default; once per pipeline run)."""
    with _lock:
        for d in (_spans, _counters):
            for name in [n for n in d if n.startswith(prefix)]:
                del d[name]


def snapshot(prefix: str = "") -> dict:
    """``{"spans": {name: {"s", "self_s", "n", "max_s", "parent"}},
    "counters": {name: value}}`` of the names beginning with `prefix`.
    ``parent`` is the enclosing span's name at the name's first call in
    the window (None at a thread's top level); ``max_s`` is its longest
    call."""
    with _lock:
        return {
            "spans": {n: dict(e) for n, e in _spans.items()
                      if n.startswith(prefix)},
            "counters": {n: v for n, v in _counters.items()
                         if n.startswith(prefix)},
        }


def rounded(snap: dict) -> dict:
    """`snap` with seconds at 6 decimals, for metrics.json."""
    def r(v):
        return round(v, 6) if isinstance(v, float) else v

    return {
        "spans": {n: {k: r(v) for k, v in e.items()}
                  for n, e in snap["spans"].items()},
        "counters": {n: r(v) for n, v in snap["counters"].items()},
    }


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _merged(intervals) -> list[list[float]]:
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _overlap(merged: list[list[float]], ends: list[float], lo: float,
             hi: float) -> float:
    """The length of [lo, hi) that the sorted disjoint `merged` intervals
    (their ends in `ends`) cover."""
    total = 0.0
    for i in range(bisect.bisect_right(ends, lo), len(merged)):
        a, b = merged[i]
        if a >= hi:
            break
        total += min(hi, b) - max(lo, a)
    return total


OUTSIDE = "outside spans"


def idle_by_span(events: list, names) -> dict:
    """The card's time over a Chrome trace's window, by program span.

    `events` are the trace's ``traceEvents``, `names` the span names to
    read (each ``user_annotation`` range of such a name is one call).
    Busy is the union of the kernel, memcpy and memset intervals; idle is
    the rest of the window (first to last timed event).  Each idle instant
    goes to exactly one owner: the most recently entered span still open
    at that instant, on any thread, or ``"outside spans"``; so the owners'
    idle sums to the window's.  Per name: ``host_s`` (its ranges' seconds,
    summed over threads), ``busy_s`` (the card's busy time inside the
    union of its ranges) and ``idle_s`` (the idle it owns)."""
    names = set(names)
    timed = [e for e in events if "ts" in e and "dur" in e]
    if not timed:
        return {"window_s": 0.0, "busy_s": 0.0, "idle_s": 0.0, "spans": {},
                OUTSIDE: {"idle_s": 0.0}}
    start = min(e["ts"] for e in timed)
    end = max(e["ts"] + e["dur"] for e in timed)
    busy = _merged((e["ts"], e["ts"] + e["dur"]) for e in timed
                   if e.get("cat") in DEVICE_CATS)
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in timed
              if e.get("cat") == "user_annotation" and e.get("name") in names]
    gaps, t = [], start
    for lo, hi in busy:
        if lo > t:
            gaps.append((t, lo))
        t = max(t, hi)
    if end > t:
        gaps.append((t, end))

    # sweep the idle gaps and the ranges' edges in time order; the owner of
    # each piece between two edges is the open range entered last (the
    # shorter first on a tie, which is the inner one)
    edges = sorted({x for g in gaps for x in g}
                   | {x for r in ranges for x in r[:2]})
    by_start = sorted(range(len(ranges)), key=lambda i: ranges[i][0])
    idle: dict[str, float] = defaultdict(float)
    heap: list = []
    nxt = 0
    gi = 0
    for a, b in zip(edges, edges[1:]):
        while gi < len(gaps) and gaps[gi][1] <= a:
            gi += 1
        if gi == len(gaps):
            break
        while nxt < len(by_start) and ranges[by_start[nxt]][0] <= a:
            lo, hi, _ = ranges[by_start[nxt]]
            heapq.heappush(heap, (-lo, hi, by_start[nxt]))
            nxt += 1
        if gaps[gi][0] > a:
            continue            # [a, b) is busy
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        owner = ranges[heap[0][2]][2] if heap else OUTSIDE
        idle[owner] += b - a

    per_name: dict[str, list] = defaultdict(list)
    for lo, hi, name in ranges:
        per_name[name].append((lo, hi))
    busy_ends = [hi for _, hi in busy]
    spans_out = {}
    for name, rs in sorted(per_name.items()):
        inside = sum(_overlap(busy, busy_ends, lo, hi)
                     for lo, hi in _merged(rs))
        spans_out[name] = {"host_s": sum(hi - lo for lo, hi in rs) / 1e6,
                           "busy_s": inside / 1e6,
                           "idle_s": idle.get(name, 0.0) / 1e6}
    busy_us = sum(hi - lo for lo, hi in busy)
    return {"window_s": (end - start) / 1e6, "busy_s": busy_us / 1e6,
            "idle_s": (end - start - busy_us) / 1e6, "spans": spans_out,
            OUTSIDE: {"idle_s": idle.get(OUTSIDE, 0.0) / 1e6}}
