"""K1 and K2: the transposed-ELL sparse matvecs, flat and batched (CUDA C++
for sm_90a)."""
