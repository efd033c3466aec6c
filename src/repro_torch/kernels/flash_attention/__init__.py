"""Causal flash attention (K6): CUDA kernel, plain version,
dispatcher with a gradient."""
