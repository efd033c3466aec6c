"""K5's plain version against the JAX package's RG-LRU recurrence, on
the CPU.

The same seeded numpy inputs go through the reference's sequential
oracle (``kernels/rg_lru/ref.py``), its Pallas kernel in interpret mode
where that kernel is valid, the model's associative scan
(``models/rglru.py::rglru_scan``, from the recurrence's own (a, b)) and
the port's ``rg_lru``.  Tolerance 1e-4 in float32, the reference's own
(``tests/test_kernels.py::TestRGLRU``).
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import jax.numpy as jnp
import numpy as np
import torch

import _torch_helpers  # noqa: F401  (caps torch's CPU threads)
from repro.kernels.rg_lru.kernel import rg_lru as pallas_rg_lru
from repro.kernels.rg_lru.ref import rg_lru_ref as j_rg_lru_ref
from repro_torch.kernels.rg_lru import ops
from repro_torch.kernels.rg_lru.ref import rg_lru_ref, rg_lru_tiled_ref

TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(rng, B, S, d, h0=True):
    a = (rng.rand(B, S, d) * 0.9).astype(np.float32)
    b = (rng.randn(B, S, d) * 0.5).astype(np.float32)
    return a, b, (rng.randn(B, d).astype(np.float32) if h0 else None)


@pytest.mark.parametrize("B,S,d,h0", [
    (2, 256, 256, False), (1, 128, 512, False), (3, 128, 128, False),
    (2, 128, 256, True), (2, 64, 96, True)])
def test_plain_matches_reference_oracle_and_pallas(B, S, d, h0):
    """S % Q == 0 and d a multiple of the tile (or d <= 256 with
    S <= Q): where the TPU kernel writes every row."""
    a, b, h = _inputs(np.random.RandomState(4), B, S, d, h0)
    jargs = [jnp.asarray(a), jnp.asarray(b)] + ([jnp.asarray(h)] if h0
                                                else [])
    targs = [torch.from_numpy(a), torch.from_numpy(b)] + (
        [torch.from_numpy(h)] if h0 else [])
    hs, hf = rg_lru_ref(*targs)
    for name, (rs, rf) in (("oracle", j_rg_lru_ref(*jargs)),
                           ("pallas", pallas_rg_lru(*jargs,
                                                    interpret=True))):
        np.testing.assert_allclose(hs.numpy(), np.asarray(rs), **TOL,
                                   err_msg=name)
        np.testing.assert_allclose(hf.numpy(), np.asarray(rf), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("S,d", [(200, 192), (1, 256), (129, 64), (7, 2560)])
def test_any_length_any_width(S, d):
    """S % 128 != 0 with d <= 256, where the TPU kernel's shape check
    (kernel.py:58) lets the call through and leaves the tail rows
    unwritten: the plain version covers every row, against the
    sequential oracle; and recurrentgemma's width at a decode step."""
    a, b, h = _inputs(np.random.RandomState(S), 2, S, d)
    hs, hf = rg_lru_ref(*map(torch.from_numpy, (a, b, h)))
    rs, rf = j_rg_lru_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h))
    np.testing.assert_allclose(hs.numpy(), np.asarray(rs), **TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(rf), **TOL)
    assert torch.equal(hs[:, -1], hf)


def test_matches_model_associative_scan(monkeypatch):
    """The model's ``rglru_scan`` recurrence (an associative scan over
    (a, b) pairs, h0 folded into b_0) on the same (a, b) and h0: its
    gates are replaced, for this test only, by this test's (a, b)."""
    from repro.models import rglru as jrglru
    rng = np.random.RandomState(11)
    B, S, d = 2, 37, 64
    a, b, h = _inputs(rng, B, S, d)
    monkeypatch.setattr(jrglru, "_gates",
                        lambda params, x: (jnp.asarray(a), jnp.asarray(b)))
    ys, hf_j = jrglru.rglru_scan({}, jnp.zeros((B, S, d), jnp.float32),
                                 jnp.asarray(h))
    hs, hf = rg_lru_ref(*map(torch.from_numpy, (a, b, h)))
    np.testing.assert_allclose(hs.numpy(), np.asarray(ys), **TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hf_j), **TOL)


def test_inert_tail_leaves_state_bit_equal():
    """a = 1, b = 0 on a chunk's tail (the serving path's inert tokens)
    gives exactly the state after the valid prefix; a lane whose chunk
    is all tail keeps its state bit for bit."""
    B, S, d = 3, 10, 48
    a, b, h = _inputs(np.random.RandomState(3), B, S, d)
    lens = np.array([10, 4, 0])
    valid = np.arange(S)[None, :, None] < lens[:, None, None]
    _, hf = rg_lru_ref(torch.from_numpy(np.where(valid, a, 1.0)
                                        .astype(np.float32)),
                       torch.from_numpy(np.where(valid, b, 0.0)
                                        .astype(np.float32)),
                       torch.from_numpy(h))
    for lane, n in enumerate(lens):
        sl = slice(lane, lane + 1)
        if n == 0:
            assert torch.equal(hf[lane], torch.from_numpy(h[lane]))
            continue
        _, hb = rg_lru_ref(torch.from_numpy(a[sl, :n]),
                           torch.from_numpy(b[sl, :n]),
                           torch.from_numpy(h[sl]))
        assert torch.equal(hf[lane], hb[0]), f"lane {lane}"


def test_dispatcher_updates_state_in_place_on_cpu():
    """``ops.rg_lru`` on CPU tensors runs the plain version, writes the
    final state into the given ``h`` and launches nothing."""
    a, b, h = map(torch.from_numpy, _inputs(np.random.RandomState(5), 2, 9,
                                            32))
    hs_ref, hf_ref = rg_lru_ref(a, b, h.clone())
    before = ops.rg_lru.launches
    hs, h_out = ops.rg_lru(a, b, h)
    assert h_out is h and torch.equal(h, hf_ref) and torch.equal(hs, hs_ref)
    hs0, h0 = ops.rg_lru(a, b)
    assert torch.equal(hs0, rg_lru_ref(a, b)[0]) and torch.equal(
        h0, hs0[:, -1])
    assert ops.rg_lru.launches == before


@pytest.mark.parametrize("S,d,route", [
    (1, 2560, "seq"),                     # a decode step
    (ops.LRU_TMA_MIN_S - 1, 2560, "seq"),
    (ops.LRU_TMA_MIN_S, 2560, "tma"),
    (64, 2560, "tma"),                    # a prefill chunk
    (200, 192, "tma"),
    (200, 98, "seq"),                     # rows the tensor map cannot stride
])
def test_lru_route_by_length_and_width(S, d, route):
    assert ops.lru_route(S, d) == route


@pytest.mark.parametrize("B,S,d", [
    (2, 128, 256),      # where the TPU kernel writes every row
    (3, 200, 192),      # a ring over S > 64, three channel tiles
    (2, 37, 100),       # a ragged last chunk and a ragged last tile
    (8, 64, 2560),      # recurrentgemma-2b's prefill chunk
])
def test_tiled_walk_bit_equal_to_plain(B, S, d):
    """The tma kernel's walk (channel tiles of 64, a ring of eight
    8-token buffers refilled in turn, zeros past S and d) is the plain
    version bit for bit; it matches the reference's sequential oracle,
    and its Pallas kernel in interpret mode where that kernel writes
    every row, at the reference's 1e-4."""
    a, b, h = _inputs(np.random.RandomState(B + S + d), B, S, d)
    a[1, 5:], b[1, 5:] = 1.0, 0.0         # an inert tail
    targs = [torch.from_numpy(x) for x in (a, b, h)]
    hs_t, hf_t = rg_lru_tiled_ref(*targs)
    hs, hf = rg_lru_ref(*targs)
    assert torch.equal(hs_t, hs) and torch.equal(hf_t, hf)
    assert torch.equal(hf_t[1], hs_t[1, 4])
    jargs = [jnp.asarray(x) for x in (a, b, h)]
    refs = [("oracle", j_rg_lru_ref(*jargs))]
    if S % 128 == 0 and d <= 256:
        refs.append(("pallas", pallas_rg_lru(*jargs, interpret=True)))
    for name, (rs, rf) in refs:
        np.testing.assert_allclose(hs_t.numpy(), np.asarray(rs), **TOL,
                                   err_msg=name)
        np.testing.assert_allclose(hf_t.numpy(), np.asarray(rf), **TOL,
                                   err_msg=name)


def test_dispatcher_counts_no_route_on_cpu():
    """A CPU tensor takes the plain version under either route's
    shapes: no launch and no route is counted."""
    routes = dict(ops.rg_lru.routes)
    for S in (1, 64):
        a, b, h = map(torch.from_numpy,
                      _inputs(np.random.RandomState(S), 2, S, 64))
        ops.rg_lru(a, b, h)
    assert ops.rg_lru.routes == routes
