"""Architecture configs of the port: pure data, copied from
`repro.configs` (`base.py` plus one file per architecture)."""
