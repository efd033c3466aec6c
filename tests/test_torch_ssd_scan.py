"""K4's plain versions against the JAX package's SSD scan, on the CPU.

The same seeded numpy inputs go through the reference's sequential
oracle (``kernels/ssd_scan/ref.py``), its Pallas kernel in interpret
mode, its iterated one-token ``ssd_decode_step`` (the recurrence the
reference's serving path runs) and the port's ``ssd_scan``; the wgmma
route's chunked dual form (``ssd_scan_chunked_ref``) against the same
oracle and Pallas kernel, from a zero and from a carried state, and
``scan_route``'s choice.
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
from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref as \
    ops_ref_chunked
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


# ------------------------------------------------- the wgmma route's form

@pytest.mark.parametrize("dtype,S,P,N,route", [
    (torch.bfloat16, 64, 64, 128, "wgmma"),    # mamba2-370m, a chunk
    (torch.bfloat16, 200, 64, 64, "wgmma"),    # N 64, several chunks
    (torch.bfloat16, ops.SCAN_WGMMA_MIN_S, 64, 128, "wgmma"),
    (torch.bfloat16, ops.SCAN_WGMMA_MIN_S - 1, 64, 128, "fma"),
    (torch.bfloat16, 1, 64, 128, "step"),      # decode
    (torch.float32, 64, 64, 128, "fma"),
    (torch.bfloat16, 64, 16, 16, "fma"),       # the smoke widths
    (torch.bfloat16, 64, 64, 100, "fma"),
    (torch.bfloat16, 64, 48, 128, "fma"),
    (torch.bfloat16, 1, 64, 64, "step"),       # decode at N 64
    (torch.bfloat16, 2, 64, 128, "fma"),
    (torch.float32, 1, 64, 128, "fma"),        # the f32 parity phases
    (torch.bfloat16, 1, 16, 16, "fma"),        # the smoke widths, decode
    (torch.float32, 1, 16, 16, "fma"),
])
def test_scan_route(dtype, S, P, N, route):
    """bf16 at P 64, N 64 or 128 takes the step route at one token and
    the wgmma route from SCAN_WGMMA_MIN_S tokens on; T = 2, float32 and
    other widths the present one."""
    assert ops.scan_route(dtype, S, P, N) == route


@pytest.mark.parametrize("S", [64, 100, 200])
def test_chunked_form_matches_reference_oracle_and_pallas(S):
    """The wgmma route's arithmetic (chunks of 64, the last one masked,
    the decay masked before its exponent, three bf16 terms a float32
    operand) from a zero state, against the JAX oracle and its Pallas
    kernel in interpret mode (chunk 100 or 64: the kernel needs chunks
    that divide S)."""
    B, H, P, N = 2, 3, 64, 32
    args = _inputs(np.random.RandomState(S), B, S, H, P, N)
    y, h = ops_ref_chunked(*_t(args))
    yr, hr = j_ssd_scan_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=1e-4,
                               rtol=1e-4)
    yk, hk = pallas_ssd_scan(*map(jnp.asarray, args),
                             chunk=64 if S % 64 == 0 else 100,
                             interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yk), atol=2e-3,
                               rtol=2e-3)
    np.testing.assert_allclose(h.numpy(),
                               np.asarray(hk.transpose(0, 1, 3, 2)),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("S", [64, 100, 200])
def test_chunked_form_from_carried_state(S):
    """From a carried state: the JAX oracle runs a 37-token prefix and
    the S tokens after it as one sequence; the chunked form starts the
    S tokens from the oracle's state after the prefix and must give the
    oracle's last S outputs and its final state.  A lane whose dt is 0
    throughout keeps its state bit for bit."""
    B, H, P, N, S0 = 3, 2, 64, 64, 37
    rng = np.random.RandomState(S + 1)
    x, dt, A, Bm, Cm, D = _inputs(rng, B, S0 + S, H, P, N)
    dt[2, S0:] = 0.0                              # lane 2 inert after S0
    pre = [a[:, :S0] for a in (x, dt)] + [A] + [a[:, :S0] for a in (Bm, Cm)]
    _, h0 = j_ssd_scan_ref(*map(jnp.asarray, pre + [D]))
    yr, hr = j_ssd_scan_ref(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)))
    post = [a[:, S0:] for a in (x, dt)] + [A] + [a[:, S0:] for a in (Bm, Cm)]
    h0 = torch.from_numpy(np.array(h0))
    y, h = ops_ref_chunked(*_t(post + [D]), h0)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr)[:, S0:], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(h[2], h0[2])


def test_three_bf16_terms_keep_one_ulp_of_the_sequential_form():
    """bf16 x, B and C, a carried state and an inert lane, at P 64, N
    128: with three bf16 terms a float32 operand the chunked form's y is
    within one bf16 ulp of the sequential plain version and its state
    within 1e-4 (the checks the card holds the kernel to).  In float32
    its y stays within 1e-5 of the sequential form's, one bf16 ulp's
    atol near zero; two terms (hi + lo) do not, and one term (the
    float32 operands rounded to bf16) leaves the state outside 1e-4."""
    B, S, H, P, N = 2, 64, 4, 64, 128
    rng = np.random.RandomState(11)
    x, dt, A, Bm, Cm, D = _inputs(rng, B, S, H, P, N)
    dt[1] = 0.0
    h0 = torch.from_numpy(rng.randn(B, H, P, N).astype(np.float32))
    args = _t((x, dt, A, Bm, Cm, D))
    for i in (0, 3, 4):
        args[i] = args[i].to(torch.bfloat16)
    y_ref, h_ref = ssd_scan_ref(*args, h0)
    y, h = ops_ref_chunked(*args, h0)
    assert y.dtype == torch.bfloat16 and torch.equal(h[1], h0[1])
    torch.testing.assert_close(h, h_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=1e-5,
                               rtol=2.0 ** -7)
    _, h1 = ops_ref_chunked(*args, h0, terms=1)
    assert (h1 - h_ref).abs().max() > 1e-4
    exact = [a.float() for a in args]               # bf16 values in f32
    yf, _ = ssd_scan_ref(*exact, h0)
    err = {terms: (ops_ref_chunked(*exact, h0, terms=terms)[0] - yf).abs()
           .max().item() for terms in (2, 3)}
    assert err[3] < 1e-5 < err[2], err


def test_dual_flops_counts_whole_chunks():
    """The dual form's tensor-core operations: per (lane, head, chunk)
    C B^T once and the three other products three times each."""
    x = torch.empty(8, 64, 32, 64)
    Bm = torch.empty(8, 64, 128)
    per = 2 * 64 * 64 * 128 + 3 * (2 * 64 * 64 * 128 + 2 * 64 * 64 * 64
                                   + 2 * 64 * 128 * 64)
    assert ops.dual_flops(x, Bm) == 8 * 32 * per
    assert ops.dual_flops(torch.empty(8, 65, 32, 64), Bm) == 2 * 8 * 32 * per


@pytest.mark.parametrize("dtype,P,N,route", [
    (torch.float32, 64, 128, "wgmma"),         # float32: the fma kernel
    (torch.bfloat16, 16, 16, "wgmma"),         # the smoke widths
    (torch.bfloat16, 64, 100, "wgmma"),
    (torch.bfloat16, 64, 128, "dual"),         # no such route
])
def test_wrapper_raises_on_what_the_route_does_not_take(dtype, P, N, route):
    """The kernel wrapper refuses a route for inputs it does not take,
    before it looks for a card (nothing falls back to the other route)."""
    B, S, H = 2, 8, 2
    x = torch.zeros(B, S, H, P, dtype=dtype)
    Bm = torch.zeros(B, S, N, dtype=dtype)
    args = (x, torch.zeros(B, S, H), torch.zeros(H), Bm, Bm.clone(),
            torch.zeros(H), torch.zeros(B, H, P, N))
    with pytest.raises(ValueError, match="route"):
        ops.ssd_scan_cuda(*args, route=route)


@pytest.mark.parametrize("dtype,S,P,N", [
    (torch.bfloat16, 8, 64, 128),              # more than one token
    (torch.bfloat16, 2, 64, 64),
    (torch.float32, 1, 64, 128),               # float32: the fma kernel
    (torch.bfloat16, 1, 16, 16),               # the smoke widths
    (torch.bfloat16, 1, 64, 100),
    (torch.float16, 1, 64, 128),               # a dtype it lacks
])
def test_step_wrapper_raises_on_what_it_does_not_take(dtype, S, P, N):
    """The step route takes one token of bf16 x, B and C at P 64 and N
    64 or 128: anything else raises before the wrapper looks for a
    card, and no launch is counted."""
    B, H = 2, 2
    x = torch.zeros(B, S, H, P, dtype=dtype)
    Bm = torch.zeros(B, S, N, dtype=dtype)
    args = (x, torch.zeros(B, S, H), torch.zeros(H), Bm, Bm.clone(),
            torch.zeros(H), torch.zeros(B, H, P, N))
    before = (ops.ssd_scan.launches, dict(ops.ssd_scan.routes))
    with pytest.raises(ValueError, match="step route"):
        ops.ssd_scan_cuda(*args, route="step")
    assert (ops.ssd_scan.launches, ops.ssd_scan.routes) == before
