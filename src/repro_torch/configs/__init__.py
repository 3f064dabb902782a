"""Configurations: the paper's own parRSB workload and pipeline presets."""
