"""The port's public kernel entry points, the counterpart of
``repro/kernels/ops.py``: the same names, keywords and defaults.

Each dispatches on its tensors' device: a CPU tensor takes the kernel's
plain version, a CUDA tensor launches the hand-written CUDA kernel or
raises.  There is no ``auto_interpret``: the device decides.  The CUDA
kernels choose their own tiles, so the ``block_*`` keywords are checked
(positive ints) for parity with the JAX call sites and otherwise ignored.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_swiglu as _fs
from repro_torch.kernels import motif_pcu as _mp
from repro_torch.kernels import rmsnorm as _rn


def _check_blocks(**blocks) -> None:
    for name, value in blocks.items():
        if isinstance(value, bool) or not isinstance(value, int) \
                or value < 1:
            raise ValueError(f"{name} must be a positive int, got {value!r}")


def fused_swiglu(x, w1, w3, *, block_m=128, block_f=128, block_k=128):
    """``silu(x @ w1) * (x @ w3)`` for x (M, D), w1/w3 (D, F)."""
    _check_blocks(block_m=block_m, block_f=block_f, block_k=block_k)
    return _fs.fused_swiglu(x, w1, w3)


def rmsnorm(x, scale, *, eps=1e-6, block_m=256):
    """RMSNorm of the rows of (M, D) ``x``, times ``scale`` (D,)."""
    _check_blocks(block_m=block_m)
    return _rn.rmsnorm(x, scale, eps)


def flash_attention(q, k, v, *, causal=True, window=0, block_q=128,
                    block_k=128):
    """Masked softmax attention over q/k/v (H, S, d)."""
    _check_blocks(block_q=block_q, block_k=block_k)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def motif_pcu(inputs, *, schedule, n_inputs, block_n=1024):
    """The value table (n_inputs + len(schedule), N) of a PCU schedule over
    inputs (n_inputs, N)."""
    _check_blocks(block_n=block_n)
    return _mp.motif_pcu(schedule, n_inputs, inputs)
