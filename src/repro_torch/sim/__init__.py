"""``repro_torch.sim`` — batched cycle-accurate verification on tensors.

* :func:`repro_torch.sim.batch.simulate_batch` / ``verify_mappings`` —
  verify many mappings per call of the cycle loop, on the card by default.
* :class:`repro_torch.sim.lower.CompiledSim` / ``lower_mapping`` — the flat
  tensor form (JSON round-trippable, schema shared with ``repro.sim``).
* :mod:`repro_torch.sim.check` — the shared tolerance policy and
  ``scalar_verdict`` over the scalar oracle.
"""
