"""The toolchain front end: the compile pipeline
(:mod:`repro_torch.compiler.pipeline`) and the mapper and fabric
registries (:mod:`~repro_torch.compiler.registry`), artifacts
(:mod:`~repro_torch.compiler.artifact`), the artifact store and its journal
(:mod:`~repro_torch.compiler.store`, :mod:`~repro_torch.compiler.journal`),
the error taxonomy, durable file I/O and fault injection, and ``python -m
repro_torch list|compile|inspect|diff|verify|store``
(:mod:`repro_torch.compiler.cli`)."""
