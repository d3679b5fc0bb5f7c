"""Model families of the port (``repro/models``): the dense / vlm family so
far, behind the one API of :mod:`repro_torch.models.zoo`."""
