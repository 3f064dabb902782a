"""Entry points: `serve` (batched KV-cache decoding of an LM arch) and
`cells` (the recsys serving steps: streamed top-k and candidate
retrieval)."""
