"""Bridge the JAX package's parameters and optimizer state into the
port.

``jax.random`` initialization cannot be reproduced with torch's
generators, so every parity test feeds both packages the same weights:
the reference's parameter tree, converted to numpy by the caller
(``jax.tree.map(np.asarray, params)``), becomes the port's tree of
tensors here, and its AdamW state the port's.  Checkpoints are the
other way across: the port's ``checkpoint/ckpt.py`` reads the JAX
trainer's.  This module imports neither ``jax`` nor ``repro``.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.layers import tree_map
from .optim.adamw import AdamWState


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


def opt_state_from_numpy(state, device="cuda") -> AdamWState:
    """The reference's ``AdamWState`` with numpy leaves (step, and the
    mu, nu and master trees) to the port's: the step an int32 scalar on
    the host, the trees float32 tensors on ``device``."""
    return AdamWState(
        torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
        *(params_from_numpy(t, device)
          for t in (state.mu, state.nu, state.master)))
