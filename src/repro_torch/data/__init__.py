"""Synthetic data (`synthetic`): the recsys batches of `repro.data`."""
