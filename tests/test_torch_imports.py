"""The import boundary of the port: ``repro_torch`` and ``chip_smoke.py``
import ``torch``, numpy and the standard library, never ``jax`` and never
any module of the JAX package ``repro`` (not even one without JAX in it),
and never ``ml_dtypes`` (the card machine has none: bf16 checkpoints go
through ``uint16`` bits).
"""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PKG = os.path.join(SRC, "repro_torch")
#: the top-level packages the port never imports
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


#: the scripts that run the port on the card, where no JAX is installed
CARD_SCRIPTS = ("flash_bwd_rounding.py", "fwd_design_probes.py",
                "ssd_parity_conditioning.py",
                "ssm_parity_conditioning.py", "train_parity_conditioning.py",
                "xent_peak.py", "torch_ab_walls.py",
                "torch_bench_place.py", "torch_bench_route.py")


#: the port's examples (the JAX package's own stay beside them)
EXAMPLES = ("torch_quickstart.py", "torch_plaid_walkthrough.py",
            "torch_serve_batched.py", "torch_train_100m.py")
#: the one module that may import PyTorch's test utilities (the fake
#: process group of the production mesh)
TESTING_INTERNAL = os.path.join(PKG, "launch", "mesh.py")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    out += [os.path.join(ROOT, "scripts", f) for f in CARD_SCRIPTS]
    out += [os.path.join(ROOT, "examples", f) for f in EXAMPLES]
    for dirpath, _dirs, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    import repro_torch

    return ["repro_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, importlib.util, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{os.path.join(ROOT, 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"for i, path in enumerate({[os.path.join(ROOT, 'examples', f) for f in EXAMPLES]!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'example{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('loaded:', len(sys.modules), 'forbidden:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "forbidden: []" in proc.stdout


def test_module_list_covers_the_package():
    mods = _modules()
    for want in ("repro_torch.device", "repro_torch.__main__",
                 "repro_torch.sim.step", "repro_torch.sim.batch",
                 "repro_torch.kernels.sim_alu", "repro_torch.compiler.cli",
                 "repro_torch.configs.base", "repro_torch.configs.llama3_2_3b",
                 "repro_torch.configs.h2o_danube_3_4b",
                 "repro_torch.configs.qwen3_14b",
                 "repro_torch.configs.stablelm_12b",
                 "repro_torch.configs.qwen2_vl_72b",
                 "repro_torch.configs.granite_moe_1b_a400m",
                 "repro_torch.configs.arctic_480b",
                 "repro_torch.configs.falcon_mamba_7b",
                 "repro_torch.configs.zamba2_1_2b",
                 "repro_torch.configs.whisper_tiny",
                 "repro_torch.kernels._launch", "repro_torch.kernels.rmsnorm",
                 "repro_torch.kernels.fused_swiglu",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.motif_pcu", "repro_torch.kernels.ops",
                 "repro_torch.models.layers", "repro_torch.models.dense",
                 "repro_torch.models.moe", "repro_torch.models.ssm",
                 "repro_torch.models.hybrid", "repro_torch.models.encdec",
                 "repro_torch.models.zoo", "repro_torch.models.convert",
                 "repro_torch.serve.kvcache", "repro_torch.serve.loop",
                 "repro_torch.launch.serve", "repro_torch.launch.train",
                 "repro_torch.train.data", "repro_torch.train.optimizer",
                 "repro_torch.train.steps", "repro_torch.train.checkpoint",
                 "repro_torch.train.loop", "repro_torch.train.tree",
                 "repro_torch.parallel.compression",
                 "repro_torch.core.arch", "repro_torch.compiler.registry",
                 "repro_torch.compiler.errors", "repro_torch.compiler.fsio",
                 "repro_torch.compiler.faultinject",
                 "repro_torch.compiler.journal", "repro_torch.compiler.store",
                 "repro_torch.core.collect", "repro_torch.core.power_area",
                 "repro_torch.core.motifs", "repro_torch.core.fusion",
                 "repro_torch.core.routing", "repro_torch.core.workloads",
                 "repro_torch.core.spatial", "repro_torch.mapping.mrrg",
                 "repro_torch.mapping.cluster", "repro_torch.mapping.mappers",
                 "repro_torch.mapping.passes.base",
                 "repro_torch.mapping.passes.route",
                 "repro_torch.mapping.passes.extract",
                 "repro_torch.mapping.passes.place",
                 "repro_torch.mapping.passes.global_place",
                 "repro_torch.mapping.passes.negotiate",
                 "repro_torch.mapping.passes.finalize",
                 "repro_torch.compiler.pipeline",
                 "repro_torch.core.runner", "repro_torch.serve_farm.protocol",
                 "repro_torch.serve_farm.client",
                 "repro_torch.serve_farm.daemon",
                 "repro_torch.compiler.__main__",
                 "repro_torch.parallel.sharding", "repro_torch.launch.mesh",
                 "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
                 "repro_torch.kernels.cost", "repro_torch.kernels.fake"):
        assert want in mods


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_import_statement(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((node.lineno, a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_torch_testing_internal_only_in_the_mesh_module(path):
    """``torch.testing._internal`` (the fake process group) is imported by
    ``repro_torch/launch/mesh.py`` alone."""
    found = [(line, name) for line, name in _imports(path)
             if name.startswith("torch.testing._internal")]
    if path == TESTING_INTERNAL:
        assert found, "the production mesh's fake group"
    else:
        assert not found, f"{path} imports {found}"


def test_examples_exist_beside_the_jax_ones():
    for name in EXAMPLES:
        assert os.path.exists(os.path.join(ROOT, "examples", name))
        assert os.path.exists(os.path.join(
            ROOT, "examples", name.replace("torch_", "")))


def _intra_imports(path, modules):
    """Module-level imports of other ``repro_torch.mapping`` modules
    (imports inside functions are lazy and cannot cycle at import time)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names if a.name in modules}
        elif (isinstance(node, ast.ImportFrom) and node.level == 0
              and node.module in modules):
            out.add(node.module)
    return out


def test_mapping_package_is_an_import_dag():
    """The layering of ``repro_torch.mapping`` (mrrg -> mapping ->
    passes.base -> passes.{route,extract} -> passes.{place,negotiate,
    finalize} -> mappers) has no module-level import cycle; the package
    ``__init__`` facades re-export everything and are left out."""
    files = {}
    for dirpath, _dirs, names in os.walk(os.path.join(PKG, "mapping")):
        for n in names:
            if n.endswith(".py") and n != "__init__.py":
                path = os.path.join(dirpath, n)
                rel = os.path.relpath(path, SRC)[:-3]
                files[rel.replace(os.sep, ".")] = path
    graph = {m: _intra_imports(p, set(files)) for m, p in files.items()}
    assert len(graph) == 11
    assert any(graph.values())  # the walk sees the package's own imports
    done, cycles = set(), []

    def visit(m, stack):
        for d in sorted(graph[m]):
            if d in stack:
                cycles.append(stack[stack.index(d):] + [d])
            elif d not in done:
                visit(d, stack + [d])
        done.add(m)

    for m in sorted(graph):
        if m not in done:
            visit(m, [m])
    assert not cycles, [" -> ".join(c) for c in cycles]
