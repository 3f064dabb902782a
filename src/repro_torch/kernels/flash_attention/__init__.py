"""K6: causal GQA flash attention with an online softmax (CUDA C++ for
sm_90a)."""
