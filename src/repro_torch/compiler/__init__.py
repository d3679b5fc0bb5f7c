"""The read side of the toolchain front end: artifacts
(:mod:`repro_torch.compiler.artifact`) and ``python -m repro_torch verify``
(:mod:`repro_torch.compiler.cli`)."""
