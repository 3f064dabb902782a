"""K5: the embedding bag — gather table rows, weight them, sum each sorted
segment (CUDA C++ for sm_90a)."""
