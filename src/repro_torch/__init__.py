"""repro_torch: the PyTorch + CUDA port of `repro` (parRSB) for the H100.

The JAX package `repro` is the reference; this package mirrors its tree
and names (`mesh/`, `core/`, `kernels/`, `configs/`) and is held against
it on identical inputs.  It imports `torch` and NumPy, never `jax` and
never `repro`: host code it needs is copied in.

Ported so far (slice A, the main path): ``partition(mesh, nparts)`` under
the ``default``, ``raw`` and ``geometric`` presets — dual graph, RCB
reorder, the level-synchronous packed Lanczos RSB engine whose matvec is
the hand-written CUDA ELL SpMV (`kernels/ell_spmv`, K1), and the repair +
refine post stages.  Entry points run on the card (``device=None`` means
``"cuda"``) unless the caller passes ``device="cpu"``.  See README.md.
"""

__version__ = "0.1.0"
