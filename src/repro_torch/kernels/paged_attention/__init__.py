"""Paged chunk attention (K1): CUDA kernel, plain version, dispatcher."""
