"""Cache probes: the CUDA STREAM triad (`triad`), the batched Prime+Probe
verdicts (`prime_probe`) and their plain versions."""
