"""The port's mixture of experts against the reference's, on the CPU.

``moe_apply`` at the mixtral-8x7b smoke config (capacity factor 64, as
the reference's serving tests use, and 1.0, where assignments drop):
both dispatch paths (flat at S = 1, per row at S > 1), with and without
a footprint mask, with padded ``token_valid``: outputs within 1e-4 in
float32, the integer meters ``dropped`` and ``routed`` exactly equal.
An all-True mask is bit-equal to no mask.  The bridge carries the
reference's MoE leaves across unchanged.  At model level, one chunked
step over a state whose experts were loaded into CLS_EXPERT pages: the
hidden states within 1e-4, the meters, pool leaves and expert tables
exactly equal; and the expert-page steps (load, bulk reference,
eviction) op for op against the reference's.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from _torch_helpers import assert_pools_equal
from repro import models as jmodels
from repro.configs import get_config, smoke_config
from repro.models import moe as jmoe
from repro.models.decode_init import empty_decode_state as j_empty
from repro.models.transformer import forward_decode_chunk as j_forward
from repro.serving import expert_pages as jexp
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.models import moe as tmoe
from repro_torch.models.decode_init import empty_decode_state as t_empty
from repro_torch.models.transformer import forward_decode_chunk as t_forward
from repro_torch.serving import expert_pages as texp

TOL = 1e-4


def _cfgs(cf=64.0, dtype=None):
    cfg = smoke_config(get_config("mixtral-8x7b"))
    tcfg = t_smoke_config(t_get_config("mixtral-8x7b"))
    out = []
    for c in (cfg, tcfg):
        c = dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=cf))
        out.append(dataclasses.replace(c, dtype=dtype) if dtype else c)
    return out


@pytest.fixture(scope="module")
def weights():
    """The reference's smoke params (seed 0) and the bridged ones."""
    cfg, _ = _cfgs()
    params = jax.tree.map(np.asarray,
                          jmodels.init_params(cfg, jax.random.PRNGKey(0)))
    return params, params_from_numpy(params, "cpu")


def _ffn(tree, g=0):
    """Layer group g's expert FFN leaves of a parameter tree."""
    return {k: v[g] for k, v in tree["groups"]["pos0"]["ffn"].items()}


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("cf", [64.0, 1.0])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B,S", [(16, 1), (3, 20)])
def test_moe_apply_matches_reference(weights, cf, masked, B, S):
    cfg, tcfg = _cfgs(cf)
    params, tparams = weights
    E = cfg.moe.num_experts
    rng = np.random.RandomState(B * 100 + S)
    # a shared component skews the routing, so capacity 1.0 drops
    x = (rng.randn(B, S, cfg.d_model)
         + 2.0 * rng.randn(cfg.d_model)).astype(np.float32)
    valid = rng.rand(B, S) < 0.8
    # footprints of one to E experts, some smaller than top_k: every
    # masked logit is MASK_NEG, so the top-k meets exact ties there
    mask = None
    if masked:
        mask = np.zeros((B, E), bool)
        for b in range(B):
            mask[b, rng.choice(E, 1 + b % E, replace=False)] = True
    jo = jmoe.moe_apply(cfg, _ffn(params), jnp.asarray(x),
                        expert_mask=None if mask is None
                        else jnp.asarray(mask),
                        token_valid=jnp.asarray(valid), metered=True)
    to = tmoe.moe_apply(tcfg, _ffn(tparams), torch.from_numpy(x),
                        expert_mask=None if mask is None
                        else torch.from_numpy(mask),
                        token_valid=torch.from_numpy(valid), metered=True)
    _close(to[0], jo[0], "out")
    for name, a, b in (("dropped", jo[1], to[1]), ("routed", jo[2], to[2])):
        assert b.dtype == torch.int32
        assert np.array_equal(np.asarray(a), b.numpy()), name
    if cf == 1.0:
        assert int(to[1].sum()) > 0, "capacity 1.0 must drop assignments"
    # every valid assignment is either kept or dropped
    assert int(to[1].sum() + to[2].sum()) == int(valid.sum()) * 2
    # unmetered: the same output
    assert torch.equal(tmoe.moe_apply(
        tcfg, _ffn(tparams), torch.from_numpy(x),
        expert_mask=None if mask is None else torch.from_numpy(mask)),
        to[0])


@pytest.mark.parametrize("B,S", [(16, 1), (3, 20)])
def test_all_true_mask_is_bit_equal_to_no_mask(weights, B, S):
    _, tcfg = _cfgs(1.0)
    _, tparams = weights
    x = torch.from_numpy(np.random.RandomState(5).randn(
        B, S, tcfg.d_model).astype(np.float32))
    full = torch.ones((B, tcfg.moe.num_experts), dtype=torch.bool)
    a = tmoe.moe_apply(tcfg, _ffn(tparams), x, metered=True)
    b = tmoe.moe_apply(tcfg, _ffn(tparams), x, expert_mask=full,
                       metered=True)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_capacity_matches_reference():
    for k, n, E, cf in ((2, 16, 4, 64.0), (2, 20, 4, 1.0), (2, 8, 8, 64.0),
                        (1, 3, 128, 1.25), (2, 64, 8, 64.0)):
        assert tmoe._capacity(k, n, E, cf) == jmoe._capacity(k, n, E, cf)
    assert tmoe.MASK_NEG == jmoe.MASK_NEG


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_moe_leaves_unchanged(dtype):
    """router float32 [d, E], w_gate/w_up [E, d, f] and w_down [E, f, d]
    (stacked over layer groups) cross with their shapes, dtypes and
    values."""
    cfg, tcfg = _cfgs(dtype=dtype)
    params = jax.tree.map(np.asarray,
                          jmodels.init_params(cfg, jax.random.PRNGKey(1)))
    got = params_from_numpy(params, "cpu")["groups"]["pos0"]["ffn"]
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    G = cfg.n_groups
    shapes = {"router": (G, d, E), "w_gate": (G, E, d, f),
              "w_up": (G, E, d, f), "w_down": (G, E, f, d)}
    for k, want in params["groups"]["pos0"]["ffn"].items():
        t = got[k]
        assert tuple(t.shape) == shapes[k] == want.shape, k
        assert str(t.dtype) == f"torch.{want.dtype}", k
        assert k != "router" or t.dtype == torch.float32
        w = (want.astype(np.float32) if want.dtype == ml_dtypes.bfloat16
             else want)
        assert np.array_equal(t.float().numpy(), w), k


def _paged_pair(cfg, tcfg, params, tparams, budget, loads):
    """Reference and port decode states (dp 1, two slots, three
    classes) with the experts ``loads`` [(pos, g, e)] loaded, the
    reference's by its own jitted load step."""
    js = j_empty(cfg, 1, 2, 64, chunk=8, size_classes=3,
                 expert_budget=budget)
    ts = t_empty(tcfg, 1, 2, 64, chunk=8, size_classes=3,
                 expert_budget=budget, device="cpu")
    host = jexp.build_host_experts(cfg, params)
    thost = texp.build_host_experts(tcfg, tparams)
    for pos in host:
        assert np.array_equal(thost[pos].numpy(), host[pos]), pos
    counts = np.zeros((1, 2), np.int32)
    counts[0, 0] = 3
    oh = np.ones(1, bool)
    for pos, g, e in loads:
        js = jax.jit(jexp.expert_load_step, static_argnums=0)(
            pos, js, jnp.asarray(counts), jnp.asarray(host[pos][g, e]),
            jnp.asarray(oh), jnp.int32(g), jnp.int32(e))
        ts = texp.expert_load_step(pos, ts, torch.from_numpy(counts),
                                   thost[pos][g, e], torch.from_numpy(oh),
                                   g, e)
    return js, ts


def _same_expert_state(js, ts, what):
    assert_pools_equal(js.pool, ts.pool, what)
    for pos, tab in js.expert_tables.items():
        assert np.array_equal(np.asarray(tab), ts.expert_tables[pos].numpy()
                              ), f"{what}: {pos} table"
    pages = np.asarray(js.expert_pages)
    assert np.array_equal(ts.expert_pages[:, :pages.shape[1]].numpy(),
                          pages), f"{what}: expert pages"


def test_paged_decode_chunk_matches_reference(weights):
    """One prefill chunk and one decode step over expert pages (two
    experts of one group missing, so the miss meter counts them),
    against the reference's forward on the same state: hidden within
    1e-4, every meter, pool leaf, expert table and page exact."""
    cfg, tcfg = _cfgs()
    params, tparams = weights
    jp = jexp.stub_expert_params(jax.tree.map(jnp.asarray, params))
    tp = texp.stub_expert_params(tparams)
    assert tp["groups"]["pos0"]["ffn"]["w_gate"].shape == (2, 4, 1, 1)
    loads = [("pos0", g, e) for g in range(cfg.n_groups)
             for e in range(cfg.moe.num_experts) if (g, e) not in
             ((1, 2), (1, 3))]
    js, ts = _paged_pair(cfg, tcfg, params, tparams, None, loads)
    _same_expert_state(js, ts, "after the loads")
    rng = np.random.RandomState(4)
    mask = np.array([[[True, True, False, True], [True] * 4]])
    for T in (8, 1):
        toks = rng.randint(1, 255, (1, 2, T)).astype(np.int32)
        lens = np.full((1, 2), T, np.int32)
        jh, js, jm = jax.jit(j_forward, static_argnums=0)(
            cfg, jp, jnp.asarray(toks), js, jnp.asarray(lens),
            expert_mask=jnp.asarray(mask))
        th, ts, tm = t_forward(tcfg, tp, torch.from_numpy(toks), ts,
                               torch.from_numpy(lens),
                               expert_mask=torch.from_numpy(mask))
        _close(th, jh, f"T={T} hidden")
        for k, v in jm.items():
            assert np.array_equal(np.asarray(v), tm[k].numpy()), (T, k)
        _same_expert_state(js, ts, f"T={T}")
        assert int(tm["expert_miss_pages"][0]) > 0
        assert int(tm["expert_hit_pages"][0]) > 0


def test_expert_ref_and_evict_steps_match_reference(weights):
    """A footprint's bulk addref and release, then the eviction of a
    referenced and of a cold expert: the pool leaves and tables op for
    op equal to the reference's."""
    cfg, tcfg = _cfgs()
    params, tparams = weights
    loads = [("pos0", g, e) for g in range(2) for e in (0, 1, 3)]
    js, ts = _paged_pair(cfg, tcfg, params, tparams, 24, loads)
    row = np.array([True, True, False, False])
    masks = {"pos0": np.broadcast_to(row, (2, 4)).copy()}
    oh = np.ones(1, bool)
    jref = jax.jit(jexp.expert_ref_step, static_argnums=0)
    jev = jax.jit(jexp.expert_evict_step, static_argnums=0)
    script = [("ref", False), ("ref", False), ("evict", (0, 1)),
              ("ref", True), ("evict", (1, 3)), ("ref", True)]
    for i, (op, arg) in enumerate(script):
        if op == "ref":
            js = jref(arg, js, jax.tree.map(jnp.asarray, masks),
                      jnp.asarray(oh))
            ts = texp.expert_ref_step(
                arg, ts, {k: torch.from_numpy(v) for k, v in masks.items()},
                torch.from_numpy(oh))
        else:
            g, e = arg
            js = jev("pos0", js, jnp.asarray(oh), jnp.int32(g), jnp.int32(e))
            ts = texp.expert_evict_step("pos0", ts, torch.from_numpy(oh),
                                        g, e)
        _same_expert_state(js, ts, f"op {i} {op}")


@pytest.mark.parametrize("cf", [64.0, 1.0])
def test_moe_apply_gradients_match_reference(weights, cf):
    """One MoE layer's backward through the sort-based dispatch (the
    per-row path, with drops at capacity 1.0): the gradients of x and
    of every expert leaf against ``jax.grad`` within 1e-4."""
    cfg, tcfg = _cfgs(cf)
    params, tparams = weights
    rng = np.random.RandomState(11)
    x = (rng.randn(2, 24, cfg.d_model)
         + 2.0 * rng.randn(cfg.d_model)).astype(np.float32)
    ct = rng.randn(2, 24, cfg.d_model).astype(np.float32)
    ffn = _ffn(params)

    def jloss(p, xx):
        return jnp.sum(jmoe.moe_apply(cfg, p, xx) * ct)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, ffn), jnp.asarray(x))
    tffn = {k: v.clone().requires_grad_(True)
            for k, v in _ffn(tparams).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = (tmoe.moe_apply(tcfg, tffn, tx) * torch.from_numpy(ct)).sum()
    loss.backward()
    _close(tx.grad, jgx, "dx")
    for k in ffn:
        _close(tffn[k].grad, jg[k], f"d{k}")
