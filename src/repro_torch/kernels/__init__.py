"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (`ref.py`) and its wrapper (`kernel.py`, `ops.py`).

  cachesim_step  per-set LRU simulation (`lru_sets`), from
                 `repro.kernels.cachesim_step`
  cache_probe    batched Prime+Probe verdicts (`prime_probe`), from
                 `repro.kernels.cache_probe`
  _lru           the shared LRU touch (`csrc/lru_touch.cuh` on the card)

The cache-hierarchy engine's wrapper lives in `repro_torch.core.cachesim`
(source `csrc/cachesim_engine.cu`).
"""
