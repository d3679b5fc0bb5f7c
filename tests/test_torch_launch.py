"""The host side of every kernel launch of the port, on the CPU.

``repro_torch.kernels._launch.check_operands`` refuses each bad operand with
the message and in the order the wrappers have always used (device, then
dtype, then contiguity, tensor by tensor); each C entry's signature in
``csrc/<name>.cu`` matches the argument types its wrapper binds, device and
stream included; and a library's build hash covers the shared headers.
Tensors that claim to lie on a card are stand-ins: this host has none.
"""
import ctypes
import importlib
import os
import re

import pytest
import torch

from repro_torch.kernels import _build, _launch

KERNELS = ["sim_alu", "rmsnorm", "fused_swiglu", "flash_attention",
           "motif_pcu"]
C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
           "long long": ctypes.c_longlong, "float": ctypes.c_float}


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


def _c_signature(name):
    """The parameter types and names of ``<name>_launch`` in its source."""
    with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
        src = f.read()
    m = re.search(rf'extern "C" int {name}_launch\((.*?)\)', src, re.S)
    assert m, f"no {name}_launch in csrc/{name}.cu"
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
