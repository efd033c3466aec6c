"""PyTorch/CUDA port of the paged serving system, beside the JAX package.

The package mirrors ``repro`` module for module where a counterpart
exists (``configs``, ``core``, ``kernels``, ``models``, ``serving``,
``runtime``) and imports neither ``jax`` nor ``repro``.  Entry points
take a ``device`` argument that defaults to ``"cuda"``; tests pass
``device="cpu"``, where each kernel wrapper runs its plain PyTorch
version.
"""
