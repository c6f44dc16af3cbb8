"""Contention-aware work placement (`rebalance`) and the leaf-name
convention of checkpoints (`sharding.path_str`).  Meshes and shardings
wait for the multi-card slice (ROADMAP.md)."""
