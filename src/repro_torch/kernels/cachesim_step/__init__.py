"""Per-set LRU simulation: CUDA `lru_sets` and its plain version."""
