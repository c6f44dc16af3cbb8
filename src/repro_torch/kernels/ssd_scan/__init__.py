"""Mamba2 SSD chunked scan: CUDA `ssd_scan` and its plain version."""
