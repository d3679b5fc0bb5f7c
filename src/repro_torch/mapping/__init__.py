"""Stored mappings rebuilt and validated for verification
(:mod:`repro_torch.mapping.mapping`)."""
