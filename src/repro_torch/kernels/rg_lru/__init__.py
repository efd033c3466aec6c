"""RG-LRU linear recurrence (K5): CUDA kernel, plain version,
dispatcher."""
