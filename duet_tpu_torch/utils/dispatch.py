"""Actual-dispatch accounting behind `metrics["backends"]`.

The pipeline's auto mode size-gates every device kernel (compile/transfer
latency only amortizes on large inputs), so config intent — "device kernels
enabled" — says nothing about what RAN.  Each kernel call site records one
event per invocation here; the per-stage backend labels in metrics.json are
derived from these counts, so a run whose stage compute never touched the
chip is labeled "host" no matter what the flags said (the reference's
run_duet.log has no such attribution at all — SURVEY.md §5.1).

Stages: snp_pileup, sv_cluster, phase_refine, haplotag, sv_decide.
Backends: host (numpy or native C++), device (single-device jit kernel),
mesh (sharded kernel with collectives), nn (neural caller, jax-managed).
Beside them, off ``STAGES`` and the labels: ``snp_features``, where the
neural caller built its candidates and features (kernel: the card's hand
kernels; host: numpy).

Each event is a counter of ``utils.spans``, ``dispatch.<stage>.<backend>``;
thread-safe (stage fan-out runs contigs on a thread pool).
"""

from __future__ import annotations

from duet_tpu_torch.utils import spans

_PREFIX = "dispatch."

STAGES = ("snp_pileup", "sv_cluster", "phase_refine", "haplotag", "sv_decide")


def record(stage: str, backend: str, n: int = 1) -> None:
    """Count `n` kernel/path invocations of `backend` for `stage`."""
    spans.count(f"{_PREFIX}{stage}.{backend}", n)


def reset() -> None:
    """Start a fresh accounting window (the pipeline resets every counter
    at once; bench runs several pipelines in one process)."""
    spans.reset(_PREFIX)


def snapshot() -> dict[str, dict[str, int]]:
    """stage -> {backend: invocation count}, for machine consumption."""
    out: dict[str, dict[str, int]] = {}
    for name, n in spans.snapshot(_PREFIX)["counters"].items():
        stage, backend = name[len(_PREFIX):].split(".")
        out.setdefault(stage, {})[backend] = n
    return out


def backend_label(stage: str, snap: dict | None = None) -> str:
    """Honest per-stage label: the backend(s) that actually dispatched.

    "unused" when the stage never ran (e.g. zero SV signatures); a mixed
    run (device windows + host fallback) is labeled "device+host" rather
    than rounded up."""
    snap = snap if snap is not None else snapshot()
    backends = sorted(b for b, n in snap.get(stage, {}).items() if n > 0)
    if not backends:
        return "unused"
    # mesh/device ahead of host in mixed labels: most-capable first
    order = {"mesh": 0, "device": 1, "nn": 2, "host": 3}
    backends.sort(key=lambda b: order.get(b, 9))
    return "+".join(backends)
