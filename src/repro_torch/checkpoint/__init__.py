"""Checkpoints of the port, in the JAX package's npz layout."""
