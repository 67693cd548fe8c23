"""Nothing of the benchmark imports JAX or the JAX package, and its
yardstick imports nothing of the program either."""

import ast
import os
import subprocess
import sys

from portbench.harness import FORBIDDEN, HERE

from .conftest import ROOT

#: the yardstick: what the program may never reach into
YARDSTICK = ("formulas.py", "generators.py", "reference.py", "trace.py", "harness.py")


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not set(imported_tops(path)) & set(FORBIDDEN), path
    for name in YARDSTICK:
        assert "repro_torch" not in set(imported_tops(HERE / name)), name


def test_a_process_that_loads_every_module_holds_no_jax():
    code = ("import importlib, pathlib, sys\n"
            "import portbench.harness as h\n"
            "for kind in ('drivers', 'metrics'):\n"
            "    for f in sorted((h.HERE / kind).glob('[a-z]*.py')):\n"
            "        importlib.import_module(f'portbench.{kind}.{f.stem}')\n"
            "import repro_torch.autotune.tuner, repro_torch.core.sweep, repro_torch.kernels.matmul.ops\n"
            "print(h.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "gemm-chain-rank",
                          "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
