"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (`ref.py`) and its wrapper (`kernel.py`, `ops.py`).

  cachesim_step  per-set LRU simulation (`lru_sets`), from
                 `repro.kernels.cachesim_step`
  cache_probe    batched Prime+Probe verdicts (`prime_probe`) and the
                 STREAM triad (`triad`, the monitor's bandwidth probe),
                 from `repro.kernels.cache_probe`
  _lru           the shared LRU touch (`csrc/lru_touch.cuh` on the card)
  flash_attention  GQA flash attention (`flash_attention_bhsd`), from
                 `repro.kernels.flash_attention`
  ssd_scan       the Mamba2 SSD chunked scan (`ssd_scan_grid`), from
                 `repro.kernels.ssd_scan`

The cache-hierarchy engine's wrapper lives in `repro_torch.core.cachesim`
(source `csrc/cachesim_engine.cu`).
"""
