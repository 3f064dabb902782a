"""repro_torch: the PyTorch + CUDA port of `repro` (parRSB) for the H100.

The JAX package `repro` is the reference; this package mirrors its tree
and names (`mesh/`, `core/`, `kernels/`, `configs/`) and is held against
it on identical inputs.  It imports `torch` and NumPy, never `jax` and
never `repro`: host code it needs is copied in.

Ported so far: the partitioner — ``partition(mesh, nparts)`` under the
``default``, ``raw``, ``geometric``, k-way and sharded-refinement presets,
by packed Lanczos (matvec on the hand-written CUDA ELL SpMV K1) or inverse
iteration with AMG (K2), with the sharded FM connection table on K4 — and
LM serving: ``launch.serve`` runs prefill and KV-cache decode of
``tinyllama-1.1b``, every attention call on the CUDA flash attention K6.
Entry points run on the card (``device=None`` means ``"cuda"``) unless the
caller passes ``device="cpu"``.  See README.md.
"""

__version__ = "0.1.0"
