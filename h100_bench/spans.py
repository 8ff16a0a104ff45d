"""Window means of the program's own spans and counters.

Each sample's metrics.json carries the program's span registry
(``duet_tpu_torch.utils.spans``): ``"spans"`` maps a span's name to its
seconds (``s``, summed over its calls and threads) and ``"counters"`` a
counter's name to its value.  A reader here takes one name's mean over the
window's samples.  A program without the registry writes neither key in
any sample: the reader then returns None and the harness leaves the metric
out.  A window sample that has the registry but not the name is a fault,
never a gap to skip, as in ``metrics.stage_mean``."""

from __future__ import annotations


def _mean(run, section: str, pick, what: str) -> float | None:
    samples = run.sample_metrics
    if samples and not any(section in m for m in samples):
        return None
    values = [pick(m[section]) if section in m else None for m in samples]
    missing = sum(v is None for v in values)
    if missing or not samples:
        raise RuntimeError(f"{what} not in {missing} of {len(samples)} "
                           f"window samples")
    return sum(values) / len(values)


def span_mean(run, name: str) -> float | None:
    """Mean seconds of the span `name` a sample."""
    return _mean(run, "spans",
                 lambda s: s[name]["s"] if name in s else None,
                 f"span {name!r}")


def spans_mean(run, prefix: str) -> float | None:
    """Mean seconds a sample of every span whose name begins with
    `prefix`, together."""
    def pick(s):
        hits = [e["s"] for n, e in s.items() if n.startswith(prefix)]
        return sum(hits) if hits else None

    return _mean(run, "spans", pick, f"spans {prefix!r}*")


def counter_mean(run, name: str) -> float | None:
    """Mean value of the counter `name` a sample."""
    return _mean(run, "counters", lambda c: c.get(name),
                 f"counter {name!r}")
