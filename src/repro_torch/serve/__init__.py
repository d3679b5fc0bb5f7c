"""Batched serving of the port (``repro/serve``): KV-cache growth and the
prefill-then-greedy-decode loop."""
