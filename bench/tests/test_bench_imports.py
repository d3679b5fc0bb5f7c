"""Nothing under ``bench/`` imports JAX or the JAX package (``repro``),
top-level names compared whole, and the reference imports nothing of the
program (``repro_torch``)."""
import ast
import os
import subprocess
import sys

import pytest

from bench.tests._util import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()))
def test_no_jax_no_jax_package(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    if os.sep + "reference" + os.sep in path:
        assert "repro_torch" not in tops, path
        assert all(m.startswith(("bench.reference", "torch", "math",
                                 "typing", "__future__"))
                   for m in imported(path)), path


def test_run_refuses_without_a_card():
    """No CUDA card: exit 2 and no result line."""
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "stablelm_12b.train_4k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=120)
    assert proc.returncode == 2 and proc.stdout.strip() == ""


def test_forbidden_modules_compares_whole_names():
    from bench.harness import cells

    bench_run = cells.load_module(os.path.join(BENCH, "run.py"),
                                  "bench_run_cli")
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_fake"] = object()
        sys.modules["repro.core.fake"] = object()
        assert "repro.core.fake" in bench_run.forbidden_modules()
        assert "repro_torch_fake" not in bench_run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
