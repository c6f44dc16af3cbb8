"""The train step (`train_step`) and the fault-tolerant training loop with
the CacheX monitor between steps (`trainer`)."""
