"""K4's plain version against the JAX package's SSD scan, on the CPU.

The same seeded numpy inputs go through the reference's sequential
oracle (``kernels/ssd_scan/ref.py``), its Pallas kernel in interpret
mode, its iterated one-token ``ssd_decode_step`` (the recurrence the
reference's serving path runs) and the port's ``ssd_scan``.
Tolerances: 1e-4 in float32 against the sequential forms (the same
recurrence in another summation order); 2e-3 against the Pallas
kernel, the reference's own tolerance for its chunked dual form
(``tests/test_kernels.py::TestSSDScan``).
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import jax.numpy as jnp
import numpy as np
import torch

import _torch_helpers  # noqa: F401  (caps torch's CPU threads)
from repro.kernels.ssd_scan.kernel import ssd_scan as pallas_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref as j_ssd_scan_ref
from repro.models.ssm import ssd_decode_step
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


def _inputs(rng, B, S, H, P, N):
    """x, dt, A, B, C, D as in tests/test_kernels.py::TestSSDScan."""
    return (rng.randn(B, S, H, P).astype(np.float32) * 0.5,
            (rng.rand(B, S, H) * 0.5 + 0.1).astype(np.float32),
            (-np.abs(rng.randn(H)) * 0.5).astype(np.float32),
            (rng.randn(B, S, N) * 0.3).astype(np.float32),
            (rng.randn(B, S, N) * 0.3).astype(np.float32),
            (rng.randn(H) * 0.1).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 256, 4, 64, 32, 64),
    (1, 128, 2, 32, 64, 128),
    (1, 128, 1, 64, 128, 32),
])
def test_plain_matches_reference_oracle_and_pallas(B, S, H, P, N, chunk):
    """From a zero state (h0 = None, the TPU kernel's function), with
    S % Q == 0: the shapes of the reference's own kernel test."""
    args = _inputs(np.random.RandomState(2), B, S, H, P, N)
    y, h = ssd_scan_ref(*_t(args))
    yr, hr = j_ssd_scan_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=1e-4,
                               rtol=1e-4)
    yk, hk = pallas_ssd_scan(*map(jnp.asarray, args), chunk=chunk,
                             interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yk), atol=2e-3,
                               rtol=2e-3)
    np.testing.assert_allclose(h.numpy(),
                               np.asarray(hk.transpose(0, 1, 3, 2)),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("S", [1, 5, 64])
def test_plain_from_h0_matches_iterated_decode_step(S):
    """From a carried state h0 != 0: S one-token ``ssd_decode_step``
    updates of the reference, the serving path's recurrence."""
    B, H, P, N = 3, 4, 16, 16
    rng = np.random.RandomState(S)
    x, dt, A, Bm, Cm, D = _inputs(rng, B, S, H, P, N)
    h0 = rng.randn(B, H, P, N).astype(np.float32)
    h = jnp.asarray(h0)
    ys = []
    for t in range(S):
        yt, h = ssd_decode_step(jnp.asarray(x[:, t]), jnp.asarray(dt[:, t]),
                                jnp.asarray(A), jnp.asarray(Bm[:, t]),
                                jnp.asarray(Cm[:, t]), jnp.asarray(D), h)
        ys.append(np.asarray(yt))
    y, hT = ssd_scan_ref(*_t((x, dt, A, Bm, Cm, D, h0)))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h), atol=1e-4,
                               rtol=1e-4)


def test_dt_zero_tail_leaves_state_bit_equal():
    """dt = 0 on a chunk's tail (the serving path's inert tokens) gives
    exactly the state after the valid prefix, and a lane whose chunk is
    all tail keeps its state bit for bit."""
    B, S, H, P, N = 3, 12, 2, 16, 16
    rng = np.random.RandomState(7)
    x, dt, A, Bm, Cm, D = _inputs(rng, B, S, H, P, N)
    h0 = rng.randn(B, H, P, N).astype(np.float32)
    lens = np.array([12, 5, 0])
    dt_gated = np.where(np.arange(S)[None, :, None] < lens[:, None, None],
                        dt, 0.0).astype(np.float32)
    _, h = ssd_scan_ref(*_t((x, dt_gated, A, Bm, Cm, D, h0)))
    for b, n in enumerate(lens):
        sl = slice(b, b + 1)
        if n == 0:
            assert torch.equal(h[b], torch.from_numpy(h0[b]))
            continue
        _, hb = ssd_scan_ref(*_t((x[sl, :n], dt[sl, :n], A, Bm[sl, :n],
                                  Cm[sl, :n], D, h0[sl])))
        assert torch.equal(h[b], hb[0]), f"lane {b}"


def test_dispatcher_updates_state_in_place_on_cpu():
    """``ops.ssd_scan`` on CPU tensors runs the plain version, writes the
    final state into the given ``h`` (the decode state's own [B, H, P,
    N] layout) and launches nothing; with no ``h`` it starts from
    zeros, as the TPU kernel does."""
    B, S, H, P, N = 2, 6, 2, 16, 16
    rng = np.random.RandomState(9)
    args = _t(_inputs(rng, B, S, H, P, N))
    h = torch.from_numpy(rng.randn(B, H, P, N).astype(np.float32))
    y_ref, h_ref = ssd_scan_ref(*args, h.clone())
    before = ops.ssd_scan.launches
    y, h_out = ops.ssd_scan(*args, h)
    assert h_out is h and torch.equal(h, h_ref) and torch.equal(y, y_ref)
    y0, h0 = ops.ssd_scan(*args)
    y0_ref, h0_ref = ssd_scan_ref(*args)
    assert torch.equal(y0, y0_ref) and torch.equal(h0, h0_ref)
    assert ops.ssd_scan.launches == before


def test_bf16_inputs_match_reference_oracle():
    """bf16 x, B and C (the model's activation type at full width): y
    in bf16, h in float32, within the reference's bf16 tolerance."""
    B, S, H, P, N = 2, 8, 2, 16, 16
    x, dt, A, Bm, Cm, D = _inputs(np.random.RandomState(4), B, S, H, P, N)
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(A),
             jnp.asarray(Bm, jnp.bfloat16), jnp.asarray(Cm, jnp.bfloat16),
             jnp.asarray(D))
    targs = [torch.from_numpy(np.array(a, np.float32)) for a in jargs]
    for i in (0, 3, 4):
        targs[i] = targs[i].to(torch.bfloat16)
    y, h = ssd_scan_ref(*targs)
    yr, hr = j_ssd_scan_ref(*jargs)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(yr, np.float32), atol=6e-2,
                               rtol=6e-2)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=1e-4,
                               rtol=1e-4)
