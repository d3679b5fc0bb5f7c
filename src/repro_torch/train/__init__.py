"""Training of the port: data, AdamW, the step functions, checkpoints and
the fault-tolerant loop (``repro/train``)."""
