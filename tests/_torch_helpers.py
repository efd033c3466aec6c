"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Importing this module caps torch's CPU threads at 2, so the port's
tests do not starve the wall-time-gated reference tests that run on
the other xdist workers.  It changes no other process-wide state.
"""

import numpy as np
import torch

torch.set_num_threads(2)


def pool_leaves(pool):
    """Flat list of numpy leaves of a ClassedPool or HierPool from either
    package, in the reference's pytree order."""
    classes = pool.classes if hasattr(pool, "classes") else (pool,)
    out = []
    for hp in classes:
        out += [np.asarray(hp.shared.free_ids), np.asarray(hp.shared.top),
                np.asarray(hp.shared.refcount), np.asarray(hp.private_ids),
                np.asarray(hp.private_top)]
    return out


def assert_pools_equal(jpool, tpool, what=""):
    for i, (a, b) in enumerate(zip(pool_leaves(jpool), pool_leaves(tpool))):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i)
        assert np.array_equal(a, b), f"{what}: pool leaf {i} differs"
