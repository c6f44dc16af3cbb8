"""CacheX's probes of an accelerator, on the card: `monitor.PodMonitor`
times the CUDA STREAM triad between training steps, `vmem_probe` finds
the largest shared-memory tile a launch takes, `ici_probe` times
`torch.distributed` collectives per mesh axis, and `pod_backend` serves
a pod's probed abstraction behind `CacheXSession` (`repro.tpuprobe` in the
JAX package)."""
