"""The torch port stands alone: no module of ``duet_tpu_torch`` nor
``chip_smoke.py`` imports the JAX package ``duet_tpu``, JAX or optax, and a
fresh interpreter that refuses duet_tpu and JAX simulates a dataset, runs
the CLI end to end under --device-stages on and off, with --stream, with
--mesh 2,2 and as two emulated processes, and imports the bench and the
smoke script; another imports every module of the port and runs the
evaluation and merge entry points."""

import ast
import glob
import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "duet_tpu_torch", "**", "*.py"),
                       recursive=True)) + ["chip_smoke.py"]


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


BLOCKED = ("duet_tpu", "jax", "jaxlib", "ml_dtypes", "optax")


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_import_of_duet_tpu(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = [(line, mod) for line, mod in _imported_modules(tree)
           if mod.split(".")[0] in BLOCKED]
    assert not bad, f"{path} imports the JAX package or JAX: {bad}"


# the CLI runs of each case: one run, or the two emulated processes of a
# multi-process run (process 1 first) against one OUTPUT
MODES = {
    "on": [["--device-stages", "on"]],
    "off": [["--device-stages", "off"]],
    "stream": [["--device-stages", "on", "--stream"]],
    "mesh": [["--mesh", "2,2"]],
    "two-process": [["--device-stages", "on", "--num-processes", "2",
                     "--process-id", pid] for pid in ("1", "0")],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_runs_with_duet_tpu_refused(tmp_path, mode):
    """The import system refuses duet_tpu, jax, jaxlib, ml_dtypes and
    optax; the port's simulator, CLI (batch under on and off, --stream
    under on, --mesh 2,2, and two emulated processes), bench and
    chip_smoke.py still work."""
    data = str(tmp_path / "data")
    out = str(tmp_path / "out")
    runs = MODES[mode]
    script = textwrap.dedent(f"""
        import importlib.abc, runpy, sys
        BLOCKED = ("duet_tpu", "jax", "jaxlib", "ml_dtypes", "optax")

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("refused import of " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        from duet_tpu_torch.sim import SimConfig, simulate_dataset
        simulate_dataset({data!r}, SimConfig(contigs={{"chr1": 50_000}},
                                             seed=6, coverage=10.0))
        import chip_smoke
        import duet_tpu_torch.bench
        for flags in {runs!r}:
            sys.argv = ["duet_tpu_torch", {data!r} + "/reads.bam",
                        {data!r} + "/ref.fa", {out!r}, "--device", "cpu",
                        *flags, "-t", "2"]
            try:
                runpy.run_module("duet_tpu_torch", run_name="__main__",
                                 alter_sys=True)
            except SystemExit as e:
                assert e.code == 0, e.code
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED)
        assert not loaded, loaded
        print("STANDALONE_RUN_OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "STANDALONE_RUN_OK" in proc.stdout
    with open(os.path.join(out, "phased_sv.vcf")) as f:
        assert f.readline().startswith("##fileformat=VCF")
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    if mode == "mesh":
        assert metrics["mesh"] == {"dp": 2, "sp": 2}
        assert metrics["backends"]["haplotag"] == "mesh"
    if mode == "two-process":
        assert os.path.exists(os.path.join(out, "metrics.p1.json"))


def test_every_module_imports_and_the_eval_tools_run_with_duet_tpu_refused(
        tmp_path):
    """Every module of the port imports in an interpreter that refuses
    duet_tpu and JAX; there ``python -m duet_tpu_torch.sim.cli_make_demo``
    writes a dataset, the CLI calls it on the host, and ``python -m
    duet_tpu_torch.eval.evaluate`` and ``python -m
    duet_tpu_torch.tools.merge`` run on the callset."""
    data = str(tmp_path / "data")
    out = str(tmp_path / "out")
    merged = str(tmp_path / "merged.vcf")
    runs = [("duet_tpu_torch.sim.cli_make_demo", [data, "--length", "60000"]),
            ("duet_tpu_torch", [data + "/reads.bam", data + "/ref.fa", out,
                                "--device", "cpu", "--device-stages", "off",
                                "-t", "2"]),
            ("duet_tpu_torch.eval.evaluate",
             [out + "/phased_sv.vcf", data + "/truth.vcf"]),
            ("duet_tpu_torch.tools.merge",
             [out + "/phased_sv.vcf", data + "/truth.vcf", "-o", merged])]
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, pkgutil, runpy, sys
        BLOCKED = {BLOCKED!r}

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("refused import of " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import duet_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            duet_tpu_torch.__path__, "duet_tpu_torch.")
            if not m.name.endswith(".__main__")]    # that one runs the CLI
        for name in names:
            importlib.import_module(name)
        print("IMPORTED", len(names))
        for module, argv in {runs!r}:
            sys.argv = [module, *argv]
            try:
                runpy.run_module(module, run_name="__main__",
                                 alter_sys=True)
            except SystemExit as e:
                assert e.code in (0, None), e.code
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED)
        assert not loaded, loaded
        print("STANDALONE_TOOLS_OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-W", "ignore::RuntimeWarning",
                           "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "STANDALONE_TOOLS_OK" in proc.stdout
    n_modules = int(proc.stdout.split("IMPORTED ", 1)[1].split()[0])
    assert n_modules >= 60, n_modules
    assert '"calling": {' in proc.stdout and "merged " in proc.stdout
    with open(merged) as f:
        assert f.readline().startswith("##fileformat=VCF")
