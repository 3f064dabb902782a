"""K3 and K4: the connection table of FM refinement, flat and batched over
shards (CUDA C++ for sm_90a)."""
