"""``repro_torch`` — the PyTorch/CUDA port of ``repro``, one slice at a time.

The verify front door: artifacts are loaded
(:mod:`repro_torch.compiler.artifact`), served from the content-addressed
store (:mod:`repro_torch.compiler.store`, shared on disk with the JAX
package), rebuilt and validated against their fabric
(:mod:`repro_torch.core.arch`), lowered into flat tensor form
(:mod:`repro_torch.sim.lower`) and proven cycle by cycle on the card
(:mod:`repro_torch.sim.step`, one ``sim_loop`` kernel launch a bucket).
The compiler maps a DFG onto a fabric (:mod:`repro_torch.mapping`,
:func:`repro_torch.compiler.pipeline.compile`) and proves each mapping
the same way.  ``python -m repro_torch
list|compile|inspect|diff|verify|store`` is the command-line entry point.
The LM substrate (``models``, ``serve``, ``train``, ``launch``) serves and
trains every family of the JAX zoo through the port's kernels.

The package imports ``torch``, numpy and the standard library only; it
never imports ``jax`` or any module of ``repro``.  Entry points run on the
card unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).
"""
import os

#: the TABLE2 x job-grid artifact corpus shipped with the package
CORPUS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "corpus", "table2")
