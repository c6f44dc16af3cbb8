"""GQA flash attention: CUDA `flash_attention` and its plain version."""
