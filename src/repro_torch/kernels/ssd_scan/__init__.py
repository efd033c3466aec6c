"""Mamba-2 SSD scan (K4): CUDA kernel, plain version, dispatcher."""
