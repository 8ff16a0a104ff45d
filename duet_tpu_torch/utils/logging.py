"""Logging with output parity to the reference's run_duet.log.

Reference: src/duet/utils.py:8-17 — root logger at INFO, console + file
handlers, '%H:%M:%S [LEVEL] message' format, stage banners framed by
25 asterisks, and per-stage elapsed-seconds lines.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager

from duet_tpu_torch.utils.spans import span

_BANNER = "*" * 25
_LOG_NAME = "duet_tpu"


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOG_NAME)


def setup_logging(output_dir: str | None = None, *, level: int = logging.INFO,
                  file_name: str = "run_duet.log") -> logging.Logger:
    log = get_logger()
    log.setLevel(level)
    log.propagate = False
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s", datefmt="%H:%M:%S")
    # Reset handlers so repeated pipeline runs (tests) don't duplicate output.
    for h in list(log.handlers):
        log.removeHandler(h)
        h.close()
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    log.addHandler(console)
    if output_dir is not None:
        fh = logging.FileHandler(f"{output_dir}/{file_name}", mode="w")
        fh.setFormatter(fmt)
        log.addHandler(fh)
    return log


def stage_banner(message: str) -> None:
    get_logger().info(f"{_BANNER} {message} {_BANNER}")


def stage_key(stage: str) -> str:
    """``"SNP CALLING"`` -> ``"snp_calling"``: the stage's span name."""
    return stage.lower().replace(" ", "_")


@contextmanager
def StageTimer(stage: str):
    """Logs '<STAGE> STARTED' / '<STAGE> COMPLETED IN <s>s' banners around a
    stage, mirroring the reference's per-stage instrumentation
    (e.g. snp_calling.py:9,19); the stage is the span ``stage_key(stage)``
    (``utils.spans``), which the block gets and whose seconds the banner
    gives."""
    stage_banner(f"{stage} STARTED")
    with span(stage_key(stage)) as s:
        yield s
    stage_banner(f"{stage} COMPLETED IN {round(s.s, 3)}s")
