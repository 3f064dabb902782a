"""Entry points: `serve` (batched KV-cache decoding of an LM arch)."""
