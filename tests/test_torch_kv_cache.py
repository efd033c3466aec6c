"""The port's paged KV cache (``repro_torch.core.kv_cache``) against the
JAX package's ``core/kv_cache.py``.

The scenarios of ``tests/test_block_pools.py::TestPagedKVCache`` (append
and gather, release, page exhaustion, a partial last page) and a seeded
sequence of every op (``append``, ``append_chunk`` with ragged and
denied chunks, ``rollback``, ``share_prefix`` with a copied-on-write
tail page, ``release``) run through both packages on the same inputs
(float32).  After every op the integer state (pool free stack, top and
refcounts, page tables, lengths, ``ok``) is exactly equal and the pages
within 1e-6.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
import torch  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import kv_cache as jkv  # noqa: E402
from repro_torch.core import kv_cache as tkv  # noqa: E402

PAGE_TOL = 1e-6


def _mk(**kw):
    d = dict(num_pages=32, page_size=4, kv_heads=2, head_dim=8,
             max_seqs=3, max_pages_per_seq=8)
    d.update(kw)
    return (tkv.create(**d, dtype=torch.float32, device="cpu"),
            jkv.create(**d, dtype=jnp.float32))


def _same(tc, jc, ok_t=None, ok_j=None):
    """Integer state exactly equal, pages within PAGE_TOL."""
    for name in ("free_ids", "top", "refcount"):
        np.testing.assert_array_equal(
            getattr(tc.pool, name).numpy(), np.asarray(getattr(jc.pool, name)),
            err_msg=f"pool.{name}")
    np.testing.assert_array_equal(tc.page_tables.numpy(),
                                  np.asarray(jc.page_tables))
    np.testing.assert_array_equal(tc.seq_lens.numpy(),
                                  np.asarray(jc.seq_lens))
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)),
                                   atol=PAGE_TOL, rtol=0, err_msg=name)
    if ok_t is not None:
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def test_append_and_gather():
    tc, jc = _mk()
    T = 10
    ks = np.random.RandomState(0).randn(T, 3, 2, 8).astype(np.float32)
    vs = np.random.RandomState(1).randn(T, 3, 2, 8).astype(np.float32)
    act = np.ones(3, bool)
    for t in range(T):
        tc, ok_t = tkv.append(tc, _t(ks[t]), _t(vs[t]), _t(act))
        jc, ok_j = jkv.append(jc, jnp.asarray(ks[t]), jnp.asarray(vs[t]),
                              jnp.asarray(act))
        _same(tc, jc, ok_t, ok_j)
        assert bool(ok_t.all())
    for s in range(3):
        k, v, valid = tkv.gather_kv(tc, s, max_len=12)
        jk, jv, jvalid = jkv.gather_kv(jc, s, max_len=12)
        np.testing.assert_allclose(k.numpy()[:T], ks[:, s], rtol=1e-6)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=PAGE_TOL)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        assert int(valid.sum()) == T


def test_release_returns_pages():
    tc, jc = _mk()
    z = np.zeros((3, 2, 8), np.float32)
    for _ in range(8):
        tc, _ = tkv.append(tc, _t(z), _t(z), torch.ones(3, dtype=torch.bool))
        jc, _ = jkv.append(jc, jnp.asarray(z), jnp.asarray(z),
                           jnp.ones(3, bool))
    assert 32 - int(tc.pool.top) == 3 * 2
    mask = np.array([True, False, True])
    tc = tkv.release(tc, _t(mask))
    jc = jkv.release(jc, jnp.asarray(mask))
    _same(tc, jc)
    assert int(tc.pool.top) == 32 - 2 and int(tc.seq_lens[1]) == 8


def test_page_exhaustion_reports_not_corrupts():
    tc, jc = _mk(num_pages=2, max_seqs=2, max_pages_per_seq=4)
    z = np.zeros((2, 2, 8), np.float32)
    oks = []
    for _ in range(6):
        tc, ok_t = tkv.append(tc, _t(z), _t(z), torch.ones(2, dtype=torch.bool))
        jc, ok_j = jkv.append(jc, jnp.asarray(z), jnp.asarray(z),
                              jnp.ones(2, bool))
        _same(tc, jc, ok_t, ok_j)
        oks.append(ok_t.numpy())
    assert oks[3].all() and not oks[4].any()
    assert np.all(tc.seq_lens.numpy() == 4)


def test_gather_kv_partial_page_not_truncated():
    tc, jc = _mk()
    ks = np.random.RandomState(2).randn(6, 3, 2, 8).astype(np.float32)
    for t in range(6):
        tc, _ = tkv.append(tc, _t(ks[t]), _t(ks[t]),
                           torch.ones(3, dtype=torch.bool))
        jc, _ = jkv.append(jc, jnp.asarray(ks[t]), jnp.asarray(ks[t]),
                           jnp.ones(3, bool))
    for max_len in (5, 6, 7):
        k, _, valid = tkv.gather_kv(tc, 1, max_len=max_len)
        jk, _, jvalid = jkv.gather_kv(jc, 1, max_len=max_len)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=PAGE_TOL)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        assert int(valid.sum()) == min(max_len, 6)


@pytest.mark.parametrize("seed", [0, 1])
def test_op_sequence_equals_reference(seed):
    """A seeded sequence of every op, state compared after each: chunks
    ragged across page boundaries, a chunk the page table cannot take, a
    pool drained to a denial, rollbacks of a whole and a partial page,
    prefix shares into emptied sequences (a full-page prefix and one with
    a copied tail page), releases of a sharing and a donor sequence, and
    every page back in the pool at the end."""
    rng = np.random.RandomState(seed)
    S, C, KH, hd = 4, 6, 2, 8
    tc, jc = _mk(num_pages=20, page_size=4, max_seqs=S, max_pages_per_seq=6)

    def chunk(lens, active=None):
        nonlocal tc, jc
        k = rng.randn(S, C, KH, hd).astype(np.float32)
        v = rng.randn(S, C, KH, hd).astype(np.float32)
        lens = np.asarray(lens, np.int32)
        act_t = None if active is None else _t(np.asarray(active))
        act_j = None if active is None else jnp.asarray(np.asarray(active))
        tc, ok_t = tkv.append_chunk(tc, _t(k), _t(v), _t(lens), act_t)
        jc, ok_j = jkv.append_chunk(jc, jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(lens), act_j)
        _same(tc, jc, ok_t, ok_j)
        return ok_t.numpy()

    def one(active):
        nonlocal tc, jc
        k = rng.randn(S, KH, hd).astype(np.float32)
        tc, ok_t = tkv.append(tc, _t(k), _t(-k), _t(np.asarray(active)))
        jc, ok_j = jkv.append(jc, jnp.asarray(k), jnp.asarray(-k),
                              jnp.asarray(np.asarray(active)))
        _same(tc, jc, ok_t, ok_j)

    chunk([6, 3, 0, 5])
    chunk([5, 6, 2, 0], active=[True, True, False, True])
    one([True, False, True, True])
    for n in ([3, 0, 1, 4], [0, 2, 0, 0]):
        tc = tkv.rollback(tc, _t(np.asarray(n, np.int32)))
        jc = jkv.rollback(jc, jnp.asarray(np.asarray(n, np.int32)))
        _same(tc, jc)
    # a share maps into an empty sequence (it does not release dst's pages)
    empty = np.array([False, False, True, True])
    tc = tkv.release(tc, _t(empty))
    jc = jkv.release(jc, jnp.asarray(empty))
    _same(tc, jc)
    for dst, src, n in ((2, 0, 4), (3, 1, 6)):
        tc, ok_t = tkv.share_prefix(tc, dst, src, n)
        jc, ok_j = jkv.share_prefix(jc, dst, src, jnp.int32(n))
        _same(tc, jc, ok_t, ok_j)
    # page tables of 6 pages and a pool of 20 fill up: chunks are denied
    oks = np.stack([chunk([6, 6, 6, 6]) for _ in range(3)])
    assert oks.any() and not oks.all()
    mask = np.array([False, True, False, True])
    tc = tkv.release(tc, _t(mask))
    jc = jkv.release(jc, jnp.asarray(mask))
    _same(tc, jc)
    tc = tkv.release(tc, torch.ones(S, dtype=torch.bool))
    jc = jkv.release(jc, jnp.ones(S, bool))
    _same(tc, jc)
    assert int(tc.pool.top) == 20 and int((tc.pool.refcount != 0).sum()) == 0
