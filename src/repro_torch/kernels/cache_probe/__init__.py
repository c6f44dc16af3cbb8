"""Batched Prime+Probe verdicts: CUDA `prime_probe` and its plain version."""
