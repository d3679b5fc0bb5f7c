"""The DFG IR and the scalar oracle (:mod:`repro_torch.core.dfg`,
:mod:`repro_torch.core.simulate`), the fabrics (:mod:`~repro_torch.core.arch`),
the power/area model and ``energy_sweep`` (:mod:`~repro_torch.core.power_area`),
the motif pass (:mod:`~repro_torch.core.motifs`,
:mod:`~repro_torch.core.fusion`) and the bench writer
(:mod:`~repro_torch.core.collect`)."""
