"""The deterministic synthetic data pipeline (`pipeline`)."""
