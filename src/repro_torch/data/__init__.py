"""Synthetic data (`synthetic`: the LM and recsys batches of `repro.data`)
and the host prefetcher (`pipeline.Prefetcher`)."""
