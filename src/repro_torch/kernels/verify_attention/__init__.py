"""Page-grouped verify attention (K3): CUDA kernel, schedule, plain
version, dispatcher."""
