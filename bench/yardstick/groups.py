"""Kernel-name groups of a device trace: a kernel belongs to the first
group one of whose keys is a part of its name.  Frozen copy of the
port's ``chip_smoke.TRACE_GROUPS`` patterns, with attention's and the
SwiGLU gate's groups widened to every route of those kernels."""

#: the port's flash_attention kernels, forward (every route) and backward
ATTENTION = ("flash_fwd_", "flash_bwd_", "flash_attention")
#: the port's fused_swiglu forward kernels (tensor-core, stream and SIMT
#: routes); the gate's backward is a group of its own
SWIGLU = ("fused_swiglu",)
#: every named group, in the order a kernel is matched
GROUPS = (
    ("attention", ATTENTION),
    ("swiglu", SWIGLU),
    ("swiglu_gate_bwd", ("swiglu_gate_bwd",)),
    ("rmsnorm", ("rmsnorm",)),
    ("cublas", ("nvjet", "gemm", "xmma", "cutlass")),
    ("scan", ("addcmul",)),
)


def group_of(name: str) -> str:
    """The group of a kernel name; ``other`` where no group's key is in
    it."""
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"
