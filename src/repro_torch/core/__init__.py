"""The DFG IR and the scalar oracle (:mod:`repro_torch.core.dfg`,
:mod:`repro_torch.core.simulate`)."""
