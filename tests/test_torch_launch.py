"""The host side of every kernel launch of the port, on the CPU.

``repro_torch.kernels._launch.check_operands`` refuses each bad operand with
the message and in the order the wrappers have always used (device, then
dtype, then contiguity, tensor by tensor); each C entry's signature in
``csrc/<name>.cu`` matches the argument types its wrapper binds, device and
stream included; a library's build hash covers the shared headers, and
every header a source includes ships with the package; every kernel module
imports without ``nvcc``; and ``sim_loop_cuda`` refuses what
its kernel does not take before any launch.
Tensors that claim to lie on a card are stand-ins: this host has none.
"""
import ctypes
import importlib
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.sim_loop import STATICS, sim_loop_cuda

KERNELS = ["sim_alu", "sim_loop", "rmsnorm", "fused_swiglu",
           "flash_attention", "motif_pcu", "adamw"]
C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
           "long long": ctypes.c_longlong, "float": ctypes.c_float,
           "void**": ctypes.POINTER(ctypes.c_void_p),
           "long long*": ctypes.POINTER(ctypes.c_longlong),
           "int*": ctypes.POINTER(ctypes.c_int)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _OnCard:
    """What ``check_operands`` reads of a CUDA tensor, without a card."""

    is_cuda = True

    def __init__(self, dtype=torch.float32, index=0, contiguous=True):
        self.dtype, self._index, self._contiguous = dtype, index, contiguous

    @property
    def device(self):
        return torch.device("cuda", self._index)

    def get_device(self):
        return self._index

    def is_contiguous(self):
        return self._contiguous


CPU = torch.zeros(2)
BF16 = torch.bfloat16

REFUSED = {
    "cpu_first": ((CPU, _OnCard()), "k needs CUDA tensors, got cpu"),
    "cpu_first_before_dtype": ((CPU.half(), _OnCard()),
                               "k needs CUDA tensors, got cpu"),
    "float16": ((_OnCard(torch.float16), _OnCard(torch.float16)),
                "k takes float32 or bfloat16, got torch.float16"),
    "cpu_second": ((_OnCard(), CPU), "k: b lies on cpu, not cuda:0"),
    "other_card": ((_OnCard(), _OnCard(index=1)),
                   "k: b lies on cuda:1, not cuda:0"),
    "other_dtype": ((_OnCard(), _OnCard(BF16)),
                    "k: b is torch.bfloat16, not torch.float32"),
    "not_contiguous": ((_OnCard(contiguous=False), _OnCard()),
                       "k: a must be contiguous"),
    "device_before_dtype": ((_OnCard(), _OnCard(BF16, index=1)),
                            "k: b lies on cuda:1"),
    "dtype_before_contiguity": ((_OnCard(), _OnCard(BF16, contiguous=False)),
                                "k: b is torch.bfloat16"),
    "first_bad_tensor_wins": ((_OnCard(), _OnCard(contiguous=False),
                               _OnCard(BF16)), "k: b must be contiguous"),
}


@pytest.mark.parametrize("case", REFUSED)
def test_check_operands_refuses_in_order(case):
    tensors, message = REFUSED[case]
    with pytest.raises(ValueError) as exc:
        _launch.check_operands("k", ("a", "b", "c"), *tensors)
    assert str(exc.value).startswith(message), str(exc.value)


@pytest.mark.parametrize("dtype,index,code", [(torch.float32, 0, 0),
                                              (BF16, 2, 1)])
def test_check_operands_returns_code_and_device(dtype, index, code):
    tensors = [_OnCard(dtype, index) for _ in range(3)]
    assert _launch.check_operands("k", ("a", "b", "c"), *tensors) == \
        (code, index)


def _c_signature(name, library=None):
    """The parameter types and names of ``<name>_launch`` in its source,
    ``csrc/<library>.cu`` (by default ``<name>.cu``)."""
    library = library or name
    with open(os.path.join(_build.CSRC, f"{library}.cu")) as f:
        src = f.read()
    m = re.search(rf'extern "C" int {name}_launch\((.*?)\)', src, re.S)
    assert m, f"no {name}_launch in csrc/{library}.cu"
    params = []
    for p in m.group(1).split(","):
        words = " ".join(p.replace("*", "* ").split()).split()
        ctype = " ".join(w for w in words[:-1] if w != "const")
        params.append((C_TYPES[ctype.replace(" *", "*")], words[-1]))
    return params


@pytest.mark.parametrize("name", KERNELS)
def test_c_entry_matches_the_bound_signature(name):
    """What ctypes passes (the wrapper's ``_ARGS``, then the device index
    and the stream) is what the C entry declares, type for type."""
    module = importlib.import_module(f"repro_torch.kernels.{name}")
    params = _c_signature(name)
    assert [t for t, _ in params] == \
        list(module._ARGS) + [ctypes.c_int, ctypes.c_void_p]
    assert [n for _, n in params[-2:]] == ["device", "stream"]
    with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
        assert '#include "device_guard.cuh"' in f.read()


#: the backward entries: (library, entry, the wrapper's argtypes attribute)
BACKWARD = [("rmsnorm", "rmsnorm_bwd", "_BWD_ARGS"),
            ("fused_swiglu", "swiglu_gate_bwd", "_GATE_ARGS"),
            ("flash_attention", "flash_attention_bwd", "_BWD_ARGS")]


@pytest.mark.parametrize("library,name,attr", BACKWARD)
def test_backward_entry_matches_the_bound_signature(library, name, attr):
    """A backward kernel's C entry sits in its forward's source and takes
    what its wrapper binds, device and stream last."""
    module = importlib.import_module(f"repro_torch.kernels.{library}")
    params = _c_signature(name, library)
    assert [t for t, _ in params] == \
        list(getattr(module, attr)) + [ctypes.c_int, ctypes.c_void_p]
    assert [n for _, n in params[-2:]] == ["device", "stream"]


def test_adamw_norm_entry_matches_the_bound_signature():
    """AdamW's norm entry sits beside its update entry (``adamw_launch``)
    and takes what its wrapper binds: the leaf table as host arrays of
    pointers, element counts and dtype codes, device and stream last."""
    from repro_torch.kernels import adamw

    params = _c_signature("adamw_norm", "adamw")
    assert [t for t, _ in params] == \
        list(adamw._NORM_ARGS) + [ctypes.c_int, ctypes.c_void_p]
    assert [n for _, n in params] == ["g", "n", "dtype", "count", "scratch",
                                      "partials", "grad_clip", "device",
                                      "stream"]


def test_flash_forward_entry_takes_the_training_outputs():
    """The forward's fifth and sixth pointers are the training form's row
    log-sum-exp and float32 output."""
    params = _c_signature("flash_attention")
    assert [n for _, n in params[:6]] == ["q", "k", "v", "out", "lse",
                                          "out32"]


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd"])
def test_flash_entries_take_a_route_code(name):
    """Both flash entries end ``(..., int dtype, int route, int device,
    void* stream)``: the wrapper passes its route rule's code
    (``fwd_route`` / ``bwd_route``) after the dtype code."""
    params = _c_signature(name, "flash_attention")
    assert [n for _, n in params[-4:]] == ["dtype", "route", "device",
                                           "stream"]
    assert [t for t, _ in params[-4:-2]] == [ctypes.c_int, ctypes.c_int]


@pytest.mark.parametrize("call", ["rmsnorm_bwd", "swiglu_gate_bwd",
                                  "flash_attention_bwd"])
def test_backward_wrappers_refuse_cpu_tensors(call):
    """A backward wrapper launches on CUDA tensors only; on the CPU the
    plain versions' autograd stands in and the wrapper refuses."""
    from repro_torch.kernels import flash_attention, fused_swiglu, rmsnorm

    x = torch.zeros(4, 8)
    fns = {
        "rmsnorm_bwd": lambda: rmsnorm.rmsnorm_bwd_cuda(x, x[0], x),
        "swiglu_gate_bwd": lambda: fused_swiglu.swiglu_gate_bwd_cuda(x, x, x),
        "flash_attention_bwd": lambda: flash_attention.
        flash_attention_bwd_cuda(x[None], x[None], x[None], x[None],
                                 x[None], x[None, :, 0]),
    }
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fns[call]()


def test_sim_loop_fit_query_matches_its_c_signature():
    """``state_in_shared`` binds ``sim_loop_state_in_shared`` with the C
    function's own parameter types."""
    from repro_torch.kernels import sim_loop

    with open(os.path.join(_build.CSRC, "sim_loop.cu")) as f:
        src = f.read()
    m = re.search(r'extern "C" int sim_loop_state_in_shared\((.*?)\)', src,
                  re.S)
    assert m
    params = [p.split() for p in m.group(1).split(",")]
    assert [C_TYPES[" ".join(p[:-1])] for p in params] == \
        sim_loop._FITS_ARGS
    assert [p[-1] for p in params] == ["N", "S", "I", "device"]


def test_library_path_covers_the_shared_headers(tmp_path):
    """An edited header, like an edited source, names a new library; an
    unrelated source does not."""
    for fn, text in (("k.cu", "a"), ("other.cu", "b"), ("guard.cuh", "c")):
        (tmp_path / fn).write_text(text)
    before = _build.library_path("k", str(tmp_path), "/b")
    assert os.path.dirname(before) == "/b"
    assert os.path.basename(before).startswith("k-")
    (tmp_path / "other.cu").write_text("b2")
    assert _build.library_path("k", str(tmp_path), "/b") == before
    (tmp_path / "guard.cuh").write_text("c2")
    after = _build.library_path("k", str(tmp_path), "/b")
    assert after != before
    (tmp_path / "k.cu").write_text("a2")
    assert _build.library_path("k", str(tmp_path), "/b") not in (before,
                                                                  after)


def test_every_kernel_source_is_a_kernel():
    """Each ``csrc/*.cu`` has its wrapper module in ``KERNELS``."""
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                     if f.endswith(".cu"))
    assert sources == sorted(KERNELS)


def test_every_include_ships_with_the_package():
    """Each ``#include "..."`` of a kernel source resolves to a file that a
    ``repro_torch`` package-data glob of ``pyproject.toml`` matches, so an
    installed package can build every kernel."""
    import fnmatch
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "repro_torch"]
    pkg = os.path.dirname(os.path.dirname(_build.CSRC))
    includes = 0
    for name in sorted(os.listdir(_build.CSRC)):
        with open(os.path.join(_build.CSRC, name)) as f:
            for header in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                                     f.read(), re.M):
                path = os.path.normpath(os.path.join(_build.CSRC, header))
                assert os.path.exists(path), (name, header)
                rel = os.path.relpath(path, pkg).replace(os.sep, "/")
                assert any(fnmatch.fnmatch(rel, g) for g in globs), (
                    name, rel, globs)
                includes += 1
    assert includes >= 10


def test_kernel_modules_import_without_nvcc(tmp_path):
    """No nvcc on PATH and a CUDA_HOME without one: every kernel module
    imports, and only the build itself reports the missing compiler."""
    code = (
        f"import importlib\n"
        f"for name in {KERNELS!r}:\n"
        f"    importlib.import_module('repro_torch.kernels.' + name)\n"
        "import repro_torch.sim.step\n"
        "from repro_torch.kernels import _build\n"
        "try:\n"
        "    _build.nvcc_path()\n"
        "except RuntimeError as e:\n"
        "    print('no nvcc:', e)\n"
    )
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=src)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "no nvcc:" in proc.stdout


def _cpu_statics(B=2, N=8, K=3, M=2, S=16):
    dims = dict(B=B, N=N, K=K, M=M, S=S)
    return {name: torch.zeros(tuple(dims[c] for c in letters), dtype=dtype)
            for name, (dtype, letters) in STATICS.items()}


def test_sim_loop_entry_refuses_cpu_tensors():
    before = sim_loop_cuda.launches
    with pytest.raises(ValueError, match="sim_loop_cuda needs CUDA tensors"):
        sim_loop_cuda(_cpu_statics(), 3)
    assert sim_loop_cuda.launches == before


class _OnCardTensor:
    """A CPU tensor that answers as one on card 0 (what ``sim_loop_cuda``
    reads before it allocates)."""

    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self.t = t
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self):
        return self.t.dim()

    def get_device(self):
        return 0

    def is_contiguous(self):
        return self.t.is_contiguous()


@pytest.mark.parametrize("name,change,message", [
    ("leaf", lambda t: t.double(), "leaf is torch.float64"),
    ("op_steps", lambda t: t[:, :4], "opcode is (2, 8), not (2, 4) (BN)"),
    ("step_abs", lambda t: t[:, :8], "step_abs is (2, 8), not (2, 16)"),
    ("exec_mask", lambda t: t.T.contiguous().T, "exec_mask must be"),
    ("issue", lambda t: t.cpu(), "issue lies on cpu"),
])
def test_sim_loop_entry_refuses_bad_statics(monkeypatch, name, change,
                                            message):
    """Each static is checked for its device, dtype, shape (in the letters
    of (B, N, K, M, S), read off op_steps and step_src) and contiguity, on
    stand-in card tensors; nothing launches."""
    statics = {k: _OnCardTensor(v) for k, v in _cpu_statics().items()}
    statics[name] = _OnCardTensor(change(statics[name].t))
    if name == "issue":
        statics[name] = statics[name].t
    launched = []
    monkeypatch.setattr(_launch, "launch",
                        lambda *args: launched.append(args))
    with pytest.raises(ValueError, match=re.escape(message)):
        sim_loop_cuda(statics, 3)
    assert not launched
