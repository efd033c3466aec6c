"""The port's device pool against the reference's, op for op.

Seeded random op traces run through ``block_pool`` (one pool),
``hier_pool`` and ``classed_pool`` (C = 1, the ``*_dp`` variants over
DP = 2 shards) of both packages.  After every op the grants, the free
stacks, the tops, the refcounts and the lane stacks must be exactly
equal.  Frees are always of references the trace holds.  The host
witness ``repro_torch.core.refpool`` (plain Python lists, the port's
copy of the reference's, held equal to it in
``test_torch_faithful.py``) runs the ``*_dp`` traces as a third executor: the same grants per
op and, through ``refpool.conforms``, the same stacks, tops and
refcounts on every shard.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import assert_pools_equal
from repro.core import block_pool as jbp
from repro.core import classed_pool as jcp
from repro.core import hier_pool as jhp
from repro_torch.core import refpool
from repro_torch.core import block_pool as tbp
from repro_torch.core import classed_pool as tcp
from repro_torch.core import hier_pool as thp

DP, BLOCKS, LANES, ELL, KMAX = 2, 40, 3, 2, 4


@functools.cache
def _jitted(fn, static):
    return jax.jit(fn, static_argnums=static)


class _Jit:
    """A reference module whose ops run jitted, Python ints static: an
    eager vmapped op costs more than its compile over a trace."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        fn = getattr(self._mod, name)
        if (not callable(fn) or isinstance(fn, type)
                or name.startswith(("create", "validate"))):
            return fn

        def call(*args):
            static = tuple(i for i, a in enumerate(args) if type(a) is int)
            return _jitted(fn, static)(*args)
        return call


jbp, jcp, jhp = _Jit(jbp), _Jit(jcp), _Jit(jhp)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(a, b, what):
    assert np.array_equal(np.asarray(a), np.asarray(b)), what


def _pick(rng, refs, k):
    """Take up to ``k`` held references (with replacement of order)."""
    out = []
    for _ in range(min(k, len(refs))):
        out.append(refs.pop(rng.randrange(len(refs))))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_block_pool_trace(seed):
    rng = random.Random(seed)
    jp, tp = jbp.create(24), tbp.create(24, device="cpu")
    refs, batches = [], []
    for step in range(30):
        op = rng.choice(["alloc", "alloc_n", "addref", "free",
                         "alloc_batch", "free_batch"])
        what = f"seed {seed} step {step} {op}"
        if op == "alloc":
            mask = np.array([rng.random() < 0.6 for _ in range(5)])
            jp, jids = jbp.alloc(jp, jnp.asarray(mask))
            tp, tids = tbp.alloc(tp, _t(mask))
            _eq(jids, tids, what)
            refs += [int(i) for i in np.asarray(jids) if i >= 0]
        elif op == "alloc_n":
            counts = np.array([rng.randint(0, KMAX) for _ in range(4)],
                              np.int32)
            jp, jids = jbp.alloc_n(jp, jnp.asarray(counts), KMAX)
            tp, tids = tbp.alloc_n(tp, _t(counts), KMAX)
            _eq(jids, tids, what)
            refs += [int(i) for i in np.asarray(jids).reshape(-1) if i >= 0]
        elif op == "addref":
            ids = [refs[rng.randrange(len(refs))] for _ in range(2)] \
                if refs else []
            row = np.array(ids + [-1] * (3 - len(ids)), np.int32)
            jp = jbp.addref(jp, jnp.asarray(row))
            tp = tbp.addref(tp, _t(row))
            refs += ids
        elif op == "free":
            ids = _pick(rng, refs, 5)
            row = np.array(ids + [-1] * (6 - len(ids)), np.int32)
            jp = jbp.free(jp, jnp.asarray(row))
            tp = tbp.free(tp, _t(row))
        elif op == "alloc_batch":
            jp, jids = jbp.alloc_batch(jp, 3)
            tp, tids = tbp.alloc_batch(tp, 3)
            _eq(jids, tids, what)
            if int(np.asarray(jids)[0]) >= 0:
                batches.append(np.asarray(jids))
        elif batches:
            row = batches.pop()
            jp = jbp.free_batch(jp, jnp.asarray(row))
            tp = tbp.free_batch(tp, _t(row))
        for a, b in zip(jp, tp):
            _eq(a, b, what)
    _eq(jbp.num_live(jp), tbp.num_live(tp), "num_live")


def _lane_rows(rng, refs, k):
    """[DP, L, K] rows of held references to free, per shard and lane."""
    out = np.full((DP, LANES, k), -1, np.int32)
    for d in range(DP):
        for lane in range(LANES):
            ids = _pick(rng, refs[d], rng.randint(0, k))
            out[d, lane, :len(ids)] = ids
    return out


@pytest.mark.parametrize("seed", range(8))
def test_hier_and_classed_pool_dp_trace(seed):
    rng = random.Random(seed)
    jh = jhp.create_dp(DP, BLOCKS, LANES, ELL)
    th = thp.create_dp(DP, BLOCKS, LANES, ELL, device="cpu")
    specs = (jcp.ClassSpec(8, BLOCKS, LANES, ELL),)
    jc = jcp.create_dp(DP, specs)
    tc = tcp.create_dp(DP, (tcp.ClassSpec(8, BLOCKS, LANES, ELL),),
                       device="cpu")
    assert_pools_equal(jh, th, "create")
    assert_pools_equal(jc, tc, "create classed")
    refs = [[] for _ in range(DP)]          # one entry per held reference
    for step in range(36):
        op = rng.choice(["alloc_n", "alloc_n", "alloc_shared", "addref",
                         "free_n", "free_n", "free_shared", "drain",
                         "refill", "rebalance"])
        what = f"seed {seed} step {step} {op}"
        if op in ("alloc_n", "alloc_shared"):
            counts = np.array([[rng.randint(0, KMAX) for _ in range(LANES)]
                               for _ in range(DP)], np.int32)
            if op == "alloc_n":
                jh, jids = jhp.alloc_n_or_shared_dp(jh, jnp.asarray(counts),
                                                    KMAX)
                th, tids = thp.alloc_n_or_shared_dp(th, _t(counts), KMAX)
                jc, cids = jcp.alloc_n_or_shared_dp(
                    jc, jcp.CLS_KV, jnp.asarray(counts), KMAX)
                tc, dids = tcp.alloc_n_or_shared_dp(tc, tcp.CLS_KV,
                                                    _t(counts), KMAX)
            else:
                jh, jids = jhp.alloc_from_shared_dp(jh, jnp.asarray(counts),
                                                    KMAX)
                th, tids = thp.alloc_from_shared_dp(th, _t(counts), KMAX)
                jc, cids = jcp.alloc_from_shared_dp(
                    jc, jcp.CLS_KV, jnp.asarray(counts), KMAX)
                tc, dids = tcp.alloc_from_shared_dp(tc, tcp.CLS_KV,
                                                    _t(counts), KMAX)
            _eq(jids, tids, what)
            _eq(cids, dids, what)
            _eq(jids, cids, what)
            for d in range(DP):
                refs[d] += [int(i) for i in np.asarray(jids)[d].reshape(-1)
                            if i >= 0]
        elif op == "addref":
            ids = np.full((DP, 2), -1, np.int32)
            for d in range(DP):
                if refs[d]:
                    ids[d, 0] = refs[d][rng.randrange(len(refs[d]))]
                    refs[d].append(int(ids[d, 0]))
            jh = jhp.addref_dp(jh, jnp.asarray(ids))
            th = thp.addref_dp(th, _t(ids))
            jc = jc._replace(classes=(jhp.addref_dp(jc.classes[0],
                                                    jnp.asarray(ids)),))
            tc = tc._replace(classes=(thp.addref_dp(tc.classes[0],
                                                    _t(ids)),))
        elif op == "free_n":
            rows = _lane_rows(rng, refs, KMAX + 3)
            jh, js = jhp.free_n_metered_dp(jh, jnp.asarray(rows))
            th, ts = thp.free_n_metered_dp(th, _t(rows))
            jc, cs = jcp.free_n_metered_dp(jc, jcp.CLS_KV, jnp.asarray(rows))
            tc, ds = tcp.free_n_metered_dp(tc, tcp.CLS_KV, _t(rows))
            _eq(js, ts, what)
            _eq(cs, ds, what)
        elif op == "free_shared":
            ids = np.full((DP, 3), -1, np.int32)
            for d in range(DP):
                got = _pick(rng, refs[d], 3)
                ids[d, :len(got)] = got
            jh = jhp.free_shared_dp(jh, jnp.asarray(ids))
            th = thp.free_shared_dp(th, _t(ids))
            jc = jc._replace(classes=(jhp.free_shared_dp(
                jc.classes[0], jnp.asarray(ids)),))
            tc = tc._replace(classes=(thp.free_shared_dp(
                tc.classes[0], _t(ids)),))
        elif op == "drain":
            jh, th = jhp.rebalance_drain_dp(jh), thp.rebalance_drain_dp(th)
            jc, tc = jcp.rebalance_drain_dp(jc), tcp.rebalance_drain_dp(tc)
        elif op == "refill":
            jh, th = jhp.rebalance_refill_dp(jh), thp.rebalance_refill_dp(th)
            jc, tc = jcp.rebalance_refill_dp(jc), tcp.rebalance_refill_dp(tc)
        else:
            jh, th = jhp.rebalance_dp(jh), thp.rebalance_dp(th)
            jc, tc = jcp.rebalance_dp(jc), tcp.rebalance_dp(tc)
        assert_pools_equal(jh, th, what)
        assert_pools_equal(jc, tc, what)
        _eq(jhp.free_per_shard(jh), thp.free_per_shard(th), what)
        _eq(jhp.live_per_shard(jh), thp.live_per_shard(th), what)
        _eq(jcp.free_per_shard(jc, 0), tcp.free_per_shard(tc, 0), what)
        # per-shard conservation holds on the port's side too
        free = thp.free_per_shard(th).numpy()
        live = thp.live_per_shard(th).numpy()
        assert (free + live == BLOCKS).all(), what
    assert tcp.lane_ell(tc, 0) == jcp.lane_ell(jc, 0) == ELL
    assert tcp.pages_local(tc, 0) == jcp.pages_local(jc, 0) == BLOCKS


def _conforms(refs, hp, what):
    """refpool's witness of each shard against a port HierPool."""
    for d in range(DP):
        msg = refpool.conforms(
            refs[d], hp.shared.free_ids[d].numpy(), hp.shared.top[d].numpy(),
            hp.private_ids[d].numpy(), hp.private_top[d].numpy(),
            hp.shared.refcount[d].numpy())
        assert msg is None, f"{what} shard {d}: {msg}"


@pytest.mark.parametrize("seed", range(6))
def test_dp_trace_conforms_to_refpool(seed):
    """Three executors of one ``*_dp`` trace: the reference's jax ops,
    the port's ``hier_pool`` and ``classed_pool``, and the sequential
    witness ``refpool`` (lane-local ``alloc_n``, bulk grants from the
    shared stack, extra references, lane frees with spill, lane-less
    frees to the shared stack, drain, refill, rebalance).  Grants agree
    per op; after every op each port shard conforms to its witness.
    Each free gives back a reference the trace holds: a base reference
    or an extra one, counted apart."""
    rng = random.Random(1000 + seed)
    jh = jhp.create_dp(DP, BLOCKS, LANES, ELL)
    th = thp.create_dp(DP, BLOCKS, LANES, ELL, device="cpu")
    tc = tcp.create_dp(DP, (tcp.ClassSpec(8, BLOCKS, LANES, ELL),),
                       device="cpu")
    refs = refpool.create_dp(DP, BLOCKS, LANES, ELL)
    crefs = refpool.create_classed_dp(DP, [(BLOCKS, LANES, ELL)])
    _conforms(refs, th, f"seed {seed} create")
    held = [[] for _ in range(DP)]          # base references
    extra = [[] for _ in range(DP)]         # references added by addref
    for step in range(40):
        op = rng.choice(["alloc_n", "alloc_shared", "addref", "free_n",
                         "free_n", "free_shared", "drain", "refill",
                         "rebalance"])
        what = f"seed {seed} step {step} {op}"
        if op in ("alloc_n", "alloc_shared"):
            hi = KMAX if op == "alloc_n" else 2
            counts = np.array([[rng.randint(0, hi) for _ in range(LANES)]
                               for _ in range(DP)], np.int32)
            if op == "alloc_n":
                jh, jids = jhp.alloc_n_dp(jh, jnp.asarray(counts), KMAX)
                th, tids = thp.alloc_n_dp(th, _t(counts), KMAX)
                hp, cids = thp.alloc_n_dp(tc.classes[0], _t(counts), KMAX)
                tc = tc._replace(classes=(hp,))
            else:
                jh, jids = jhp.alloc_from_shared_dp(jh, jnp.asarray(counts),
                                                    KMAX)
                th, tids = thp.alloc_from_shared_dp(th, _t(counts), KMAX)
                tc, cids = tcp.alloc_from_shared_dp(tc, tcp.CLS_KV,
                                                    _t(counts), KMAX)
            _eq(jids, tids, what)
            _eq(tids, cids, what)
            for d in range(DP):
                fn = "alloc_n" if op == "alloc_n" else "alloc_from_shared"
                rows = getattr(refs[d], fn)(counts[d], KMAX)
                getattr(crefs[d], fn)(0, counts[d], KMAX)
                for lane, row in enumerate(rows):
                    want = row + [-1] * (KMAX - len(row))
                    assert tids[d, lane].tolist() == want, what
                    held[d] += row
        elif op == "addref":
            ids = np.full((DP, 2), -1, np.int32)
            for d in range(DP):
                if held[d] and rng.random() < 0.8:
                    ids[d, 0] = rng.choice(held[d])
                    extra[d].append(int(ids[d, 0]))
                refs[d].addref(ids[d].tolist())
                crefs[d].addref(0, ids[d].tolist())
            jh = jhp.addref_dp(jh, jnp.asarray(ids))
            th = thp.addref_dp(th, _t(ids))
            tc = tcp.addref_dp(tc, tcp.CLS_KV, _t(ids))
        elif op == "free_n":
            rows = np.full((DP, LANES, KMAX), -1, np.int32)
            for d in range(DP):
                for lane in range(LANES):
                    got = _pick(rng, held[d], rng.randint(0, 2))
                    rows[d, lane, :len(got)] = got
            jh, js = jhp.free_n_metered_dp(jh, jnp.asarray(rows))
            th, ts = thp.free_n_metered_dp(th, _t(rows))
            tc, cs = tcp.free_n_metered_dp(tc, tcp.CLS_KV, _t(rows))
            _eq(js, ts, what)
            _eq(ts, cs, what)
            for d in range(DP):
                spill = refs[d].free_n(rows[d].tolist())
                crefs[d].free_n(0, rows[d].tolist())
                assert int(ts[d]) == spill, what
        elif op == "free_shared":
            ids = np.full((DP, 2), -1, np.int32)
            for d in range(DP):
                got = _pick(rng, extra[d], 2)
                ids[d, :len(got)] = got
                refs[d].free_shared(ids[d].tolist())
                crefs[d].free_shared(0, ids[d].tolist())
            jh = jhp.free_shared_dp(jh, jnp.asarray(ids))
            th = thp.free_shared_dp(th, _t(ids))
            tc = tcp.free_shared_dp(tc, tcp.CLS_KV, _t(ids))
        else:
            fn = {"drain": "rebalance_drain", "refill": "rebalance_refill",
                  "rebalance": "rebalance"}[op]
            jh = getattr(jhp, fn + "_dp")(jh)
            th = getattr(thp, fn + "_dp")(th)
            tc = getattr(tcp, fn + "_dp")(tc)
            for d in range(DP):
                getattr(refs[d], fn)()
                getattr(crefs[d], fn)()
        assert_pools_equal(jh, th, what)
        assert_pools_equal(th, tc, what)
        _conforms(refs, th, what)
        for d in range(DP):
            msg = refpool.conforms_classed(crefs[d], tc, d)
            assert msg is None, f"{what} shard {d}: {msg}"
            assert refs[d].free_total() + refs[d].num_live() == BLOCKS


@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_page_plan_and_granted_mask(seed):
    rng = np.random.RandomState(seed)
    seq = rng.randint(0, 40, (DP, LANES)).astype(np.int32)
    lens = rng.randint(0, 12, (DP, LANES)).astype(np.int32)
    for a, b in zip(jbp.chunk_page_plan(jnp.asarray(seq), jnp.asarray(lens),
                                        8, 6),
                    tbp.chunk_page_plan(_t(seq), _t(lens), 8, 6)):
        _eq(a, b, "chunk_page_plan")
    ids = rng.randint(-1, 9, (DP, LANES, KMAX)).astype(np.int32)
    counts = rng.randint(0, KMAX + 1, (DP, LANES)).astype(np.int32)
    _eq(jbp.granted_mask(jnp.asarray(ids), jnp.asarray(counts)),
        tbp.granted_mask(_t(ids), _t(counts)), "granted_mask")


def test_validate_plan_matches():
    for args in ((100, 4, 2, 70), (100, 4, 2, 80)):
        ok = jhp.validate_plan(*args, degraded_ok=True)
        assert thp.validate_plan(*args, degraded_ok=True) == ok
    with pytest.raises(ValueError):
        thp.validate_plan(100, 4, 2, 80)
