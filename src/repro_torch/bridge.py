"""Bridge the JAX package's parameters into the port.

``jax.random`` initialization cannot be reproduced with torch's
generators, so every parity test feeds both packages the same weights:
the reference's parameter tree, converted to numpy by the caller
(``jax.tree.map(np.asarray, params)``), becomes the port's tree of
tensors here.  This module imports neither ``jax`` nor ``repro``.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.layers import tree_map


def to_tensor(a, device="cuda") -> torch.Tensor:
    """One numpy array (bfloat16 included, as ``ml_dtypes`` gives it)
    to a tensor of the same dtype on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device="cuda"):
    """A nested dict of numpy arrays (the reference's parameter tree)
    to the port's nested dict of tensors: same keys, shapes, dtypes."""
    return tree_map(lambda a: to_tensor(a, device), tree)
