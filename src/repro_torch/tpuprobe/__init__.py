"""The CacheX monitor on the card: `monitor.PodMonitor` times the CUDA
STREAM triad between training steps (`repro.tpuprobe` in the JAX
package; its VMEM, ICI and pod-backend probes are not ported yet)."""
