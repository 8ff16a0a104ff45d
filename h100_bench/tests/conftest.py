"""Shared fixtures of the benchmark's CPU tests: the cells' configurations
cut to a test size."""

import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

# each configuration at a size a test run holds: the same parameters on
# shorter contigs
TEST_CONTIGS = {"synth-ont-q20-20x": {"chr20": 150_000, "chr21": 120_000},
                "synth-ont-q10-10x": {"chr21": 300_000}}


def small_config(name: str, out_dir: str) -> str:
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg["sim"]["contigs"] = TEST_CONTIGS[name]
    path = os.path.join(out_dir, name + ".json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def simulate(config_path: str, seed: int, out: str) -> str:
    subprocess.run([sys.executable, "-m", "h100_bench.sim", config_path,
                    str(seed), out], check=True, cwd=ROOT)
    return out


@pytest.fixture(scope="session")
def small_data(tmp_path_factory):
    """name -> the directory of a simulated input of that configuration."""
    root = tmp_path_factory.mktemp("h100_bench_data")
    return {name: simulate(small_config(name, str(root)), 20261017,
                           str(root / name)) for name in TEST_CONTIGS}
