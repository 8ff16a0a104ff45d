"""Build the program's kernels and native ingest, and report the cards:
``python -m h100_bench.build [--none]``.

Run as a child of the harness, so that the measuring process touches no
CUDA before its cold sample.  The libraries land in the program's own
build cache (``build/duet_tpu_torch/``), which later runs in the same
checkout reuse.  The last line of the output is a JSON object:
``{"cuda": bool, "count": int}``.  ``--none`` builds nothing and reports
no card (the CPU tests)."""

import json
import sys


def main(argv: list[str]) -> int:
    if argv == ["--none"]:
        print(json.dumps({"cuda": False, "count": 0}))
        return 0
    import torch

    from duet_tpu_torch.io.native_ingest import get_lib
    from duet_tpu_torch.ops.haplotag_kernel import build

    get_lib()
    cuda = torch.cuda.is_available()
    if cuda:
        build()
    print(json.dumps({"cuda": cuda,
                      "count": torch.cuda.device_count() if cuda else 0}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
