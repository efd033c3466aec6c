"""K1, paged chunk attention: the port's plain version against the
reference's jnp oracle and its Pallas kernel run in interpret mode, on
the shape sweep of ``tests/test_kernels.py``; the dispatcher's CPU
path.  The CUDA kernel itself is held against the plain version on
the card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import jax.numpy as jnp
import numpy as np
import torch

import _torch_helpers  # noqa: F401  (caps torch's CPU threads)
from repro.kernels.paged_attention.kernel import paged_attention_chunk \
    as pallas_chunk
from repro.kernels.paged_attention.ref import (paged_attention_chunk_ref,
                                               paged_attention_ref)
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import \
    paged_attention_chunk_ref as plain

TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _tol(dt):
    return 1e-4 if dt == jnp.float32 else 6e-2


def _case(rng, B, T, H, KH, hd, psz, maxp, P, dt=jnp.float32,
          ragged_base=True):
    """The reference suite's inputs (tests/test_kernels.py), as numpy."""
    hi = max((maxp - 1) * psz - T, 1)
    base = (rng.randint(0, hi, B).astype(np.int32) if ragged_base
            else np.zeros(B, np.int32))
    q = rng.randn(B, T, H, hd).astype(np.float32)
    kp = rng.randn(P, psz, KH, hd).astype(np.float32)
    vp = rng.randn(P, psz, KH, hd).astype(np.float32)
    table = np.full((B, maxp), -1, np.int32)
    avail = list(range(P))
    rng.shuffle(avail)
    for b in range(B):
        for i in range(int(np.ceil((base[b] + T) / psz))):
            table[b, i] = avail.pop()
    return q, kp, vp, table, base


def _both(q, kp, vp, table, base, dt=jnp.float32):
    """(jax inputs, torch inputs) in dtype ``dt`` from one numpy case."""
    j = (jnp.asarray(q, dt), jnp.asarray(kp, dt), jnp.asarray(vp, dt),
         jnp.asarray(table), jnp.asarray(base))
    tdt = TORCH_DT[dt]
    t = (torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
         torch.from_numpy(vp).to(tdt), torch.from_numpy(table),
         torch.from_numpy(base))
    return j, t


def _close(out, ref, tol):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,T,H,KH,hd,psz,maxp,P,dt,pallas", [
    (3, 4, 8, 2, 64, 8, 5, 32, jnp.float32, True),
    (2, 8, 4, 4, 64, 8, 4, 32, jnp.float32, True),
    (2, 5, 8, 1, 128, 16, 3, 16, jnp.bfloat16, True),
    (1, 16, 16, 8, 64, 16, 4, 48, jnp.float32, True),
    (4, 3, 4, 2, 16, 8, 6, 32, jnp.float32, False),   # smoke shape, G = 2
    (2, 4, 4, 4, 128, 64, 3, 8, jnp.float32, False),  # olmo-1b hd/psz
])
def test_plain_vs_ref_and_pallas(B, T, H, KH, hd, psz, maxp, P, dt, pallas):
    """The reference suite's shape sweep (Pallas in interpret mode) and
    the port's own serving shapes (against the jnp oracle)."""
    rng = np.random.RandomState(hash((B, T, H, KH)) % 2**31)
    j, t = _both(*_case(rng, B, T, H, KH, hd, psz, maxp, P), dt)
    out = plain(*t)
    assert out.dtype == TORCH_DT[dt] and out.shape == (B, T, H, hd)
    _close(out, paged_attention_chunk_ref(*j), _tol(dt))
    if pallas:
        _close(out, pallas_chunk(*j, interpret=True), _tol(dt))


@pytest.mark.parametrize("G", [1, 2])
def test_t1_matches_single_token_ref(G):
    """At T = 1 the chunk function is single-token decode over
    base + 1 tokens (the reference's decode oracle)."""
    rng = np.random.RandomState(11 + G)
    q, kp, vp, table, base = _case(rng, 3, 1, 2 * G, 2, 64, 8, 4, 24)
    j, t = _both(q, kp, vp, table, base)
    ref = paged_attention_ref(j[0][:, 0], *j[1:4], j[4] + 1)
    _close(plain(*t)[:, 0], ref, 1e-4)
    _close(plain(*t), paged_attention_chunk_ref(*j), 1e-4)


def test_causal_within_chunk():
    """Row t ignores chunk tokens at positions > base + t."""
    rng = np.random.RandomState(12)
    q, kp, vp, table, base = _case(rng, 1, 6, 4, 2, 64, 8, 3, 12,
                                   ragged_base=False)
    out1 = plain(*_both(q, kp, vp, table, base)[1])
    tcut = 3
    kp2, vp2 = kp.copy(), vp.copy()
    for tt in range(tcut, 6):
        pos = int(base[0]) + tt
        kp2[table[0, pos // 8], pos % 8] = 99.0
        vp2[table[0, pos // 8], pos % 8] = -99.0
    j2, t2 = _both(q, kp2, vp2, table, base)
    out2 = plain(*t2)
    np.testing.assert_allclose(out1[:, :tcut].numpy(),
                               out2[:, :tcut].numpy(), atol=1e-6, rtol=1e-6)
    assert not np.allclose(out1[:, tcut:].numpy(), out2[:, tcut:].numpy())
    _close(out2, paged_attention_chunk_ref(*j2), 1e-4)


@pytest.mark.parametrize("G", [1, 2])
def test_all_masked_rows_and_dead_pages(G):
    """An idle slot (table all -1) outputs exact zeros; a dead page in
    the middle of a live table is skipped, as the reference skips it."""
    rng = np.random.RandomState(13 + G)
    q, kp, vp, table, base = _case(rng, 3, 4, 2 * G, 2, 64, 8, 5, 32)
    table[1] = -1
    base[1] = 0
    table[2, 0] = -1                       # dead page inside the live run
    j, t = _both(q, kp, vp, table, base)
    out = plain(*t)
    assert (out[1] == 0).all()
    _close(out, paged_attention_chunk_ref(*j), 1e-4)
    if G == 2:
        _close(out, pallas_chunk(*j, interpret=True), 1e-4)


def test_dispatcher_takes_plain_version_on_cpu():
    rng = np.random.RandomState(14)
    t = _both(*_case(rng, 2, 4, 4, 2, 16, 8, 4, 16))[1]
    before = ops.paged_attention_chunk.launches
    out = ops.paged_attention_chunk(*t)
    assert ops.paged_attention_chunk.launches == before
    assert torch.equal(out, plain(*t))
    n = ops.bound_bytes(t[0], t[1], t[3], t[4])
    assert n > 2 * t[0].numel() * 4
