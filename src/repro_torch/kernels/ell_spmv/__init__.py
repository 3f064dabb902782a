"""K1: the transposed-ELL sparse matvec (CUDA C++ for sm_90a)."""
