"""Hand-written Hopper kernels, each a triple: the kernel's loader and
wrapper (`cuda.py`), its plain PyTorch version (`ref.py`), and the
dispatch (`ops.py`)."""
