"""Stored mappings rebuilt for verification (:mod:`repro_torch.mapping.mapping`)."""
