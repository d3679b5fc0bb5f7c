"""The toolchain front end: artifacts (:mod:`repro_torch.compiler.artifact`),
the artifact store and its journal (:mod:`~repro_torch.compiler.store`,
:mod:`~repro_torch.compiler.journal`), the error taxonomy, durable file I/O
and fault injection, and ``python -m repro_torch verify|store``
(:mod:`repro_torch.compiler.cli`)."""
