"""Distributed-optimization pieces of the port (``repro/parallel``)."""
