"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each library is compiled from the sources in ``duet_tpu_torch/csrc/`` for
``sm_90a`` (Hopper) into ``build/duet_tpu_torch/<name>-<hash>/`` beside the
package, at first use, keyed by a hash of the sources and flags — so a fresh
checkout builds once and an edited source rebuilds.  The kernels expose a
plain C interface (no PyTorch headers), which keeps a build to seconds.

Libraries build independently: two threads loading two libraries run
their nvcc processes at the same time.  There is no fallback: a missing
nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "duet_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()                     # guards _name_locks
_name_locks: dict[str, threading.Lock] = {}  # one build at a time per name
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"path", "seconds", "built", "log"}: what the last load did
BUILD_INFO: dict[str, dict] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of duet_tpu_torch are built from source")
    return found


def load(name: str, sources: list[str]) -> ctypes.CDLL:
    """The ctypes library `name` built from `sources` (file names under
    csrc/), building it first if this source hash has no library yet."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        paths = [os.path.join(CSRC_DIR, s) for s in sources]
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in paths:
            with open(p, "rb") as f:
                h.update(f.read())
        out_dir = os.path.join(BUILD_ROOT, f"{name}-{h.hexdigest()[:16]}")
        so = os.path.join(out_dir, f"lib{name}.so")
        t0 = time.perf_counter()
        built = not os.path.exists(so)
        log = ""
        if built:
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} "
                                   f"(exit {proc.returncode}):\n{log}")
            with open(os.path.join(out_dir, "build.log"), "w") as f:
                f.write(log)
            os.replace(tmp, so)  # atomic: a reader never sees a torn library
        lib = ctypes.CDLL(so)
        BUILD_INFO[name] = {"path": so, "built": built, "log": log,
                            "seconds": round(time.perf_counter() - t0, 3)}
        _libs[name] = lib
        return lib
