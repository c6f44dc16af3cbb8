"""Serving: the wave-scheduled `ServeEngine` and the CAS `ReplicaRouter`
(`repro.serve` in the JAX package)."""
