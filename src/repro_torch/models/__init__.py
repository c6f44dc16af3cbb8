"""The LM stack of the port: `layers`, `attention`, `mamba2` and `lm`,
mirroring `repro.models` (the MoE family is not ported yet)."""
