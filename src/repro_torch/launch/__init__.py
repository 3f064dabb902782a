"""Entry points: `serve` (batched KV-cache decoding of an LM arch), `train`
(AdamW steps with checkpoint/resume of an LM or recsys arch) and `cells`
(the LM and recsys train steps, the recsys serving steps: streamed top-k
and candidate retrieval)."""
