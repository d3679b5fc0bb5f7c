"""The port's four examples (``examples/torch_*.py``) and ``python -m
repro_torch.compiler`` on the CPU: each example runs at its smallest
settings under ``--device cpu`` and exits 0; without a card its default
device (``cuda``) raises.  The card runs ``torch_quickstart.py`` in
``chip_smoke.py``'s plan phase."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ENV = dict(os.environ, PYTHONPATH=SRC)

#: each example at its smallest settings, on the CPU
EXAMPLES = {
    "torch_quickstart.py": ["--device", "cpu", "--steps", "2"],
    "torch_plaid_walkthrough.py": ["atax", "2", "--device", "cpu"],
    "torch_serve_batched.py": ["--device", "cpu", "--new-tokens", "2"],
    "torch_train_100m.py": ["--device", "cpu", "--steps", "1", "--seq",
                            "32", "--batch", "2"],
}


def _run(args, timeout=300):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, env=ENV, cwd=ROOT)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args = [os.path.join(ROOT, "examples", name), *EXAMPLES[name]]
    if name == "torch_train_100m.py":
        args += ["--ckpt-dir", str(tmp_path / "ckpt")]
    proc = _run(args)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "on cpu" in proc.stdout or name in ("torch_plaid_walkthrough.py",
                                               "torch_serve_batched.py")


def test_examples_default_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    proc = _run([os.path.join(ROOT, "examples", "torch_serve_batched.py")])
    assert proc.returncode != 0
    assert "runs on a CUDA device by default" in proc.stderr


def test_walkthrough_verifies_both_mappings():
    proc = _run([os.path.join(ROOT, "examples", "torch_plaid_walkthrough.py"),
                 "atax", "2", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("(verified, cpu)") == 2


def test_python_m_repro_torch_compiler_is_the_cli():
    a = _run(["-m", "repro_torch.compiler", "list"])
    b = _run(["-m", "repro_torch", "list"])
    assert a.returncode == b.returncode == 0, a.stderr + b.stderr
    assert a.stdout == b.stdout and "hierarchical" in a.stdout
