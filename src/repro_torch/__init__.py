"""``repro_torch`` — the PyTorch/CUDA port of ``repro``, one slice at a time.

This slice ports batched verification of stored mappings: artifacts are
loaded (:mod:`repro_torch.compiler.artifact`), lowered into flat tensor
form (:mod:`repro_torch.sim.lower`) and proven cycle by cycle on the card
(:mod:`repro_torch.sim.step`), with the ALU stage as a hand-written CUDA
kernel (:mod:`repro_torch.kernels.sim_alu`).  ``python -m repro_torch
verify PATHS...`` is the command-line entry point.

The package imports ``torch``, numpy and the standard library only; it
never imports ``jax`` or any module of ``repro``.  Entry points run on the
card unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).
"""
import os

#: the TABLE2 x job-grid artifact corpus shipped with the package
CORPUS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "corpus", "table2")
