"""The port's decode path against the reference's, on bridged weights.

``decode_step_chunk`` on the olmo-1b and llama3.2-1b smoke configs
(DP = 2, B_local = 2): per-position logits within 1e-4, page tables,
``seq_lens`` and every pool leaf exactly equal, step after step.  Also
the reference's own chunk-vs-single-token contract on the port, pool
denial, and the parameter tree of ``init_params``.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import assert_pools_equal
from repro import models as jmodels
from repro.configs import get_config, smoke_config
from repro.models.decode_init import empty_decode_state as j_empty
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.models import model as tmodel
from repro_torch.models.decode_init import empty_decode_state as t_empty


#: the reference's chunk step, jitted (eager op-by-op dispatch of the
#: whole model costs more than its compile)
j_step_chunk = jax.jit(jmodels.decode_step_chunk, static_argnums=0)


def _setup(arch):
    cfg = smoke_config(get_config(arch))
    tcfg = t_smoke_config(t_get_config(arch))
    params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, tcfg, tparams


@pytest.mark.parametrize("arch", ["olmo-1b", "llama3.2-1b"])
def test_decode_step_chunk_matches_reference(arch):
    cfg, params, tcfg, tparams = _setup(arch)
    rng = np.random.RandomState(3)
    js = j_empty(cfg, 2, 2, 64)
    ts = t_empty(tcfg, 2, 2, 64, device="cpu")
    for step in range(5):
        T = 8 if step < 3 else 1
        toks = rng.randint(1, 255, (2, 2, T)).astype(np.int32)
        lens = rng.randint(0, T + 1, (2, 2)).astype(np.int32)
        active = rng.rand(2, 2) < 0.8
        jl, js, jok = j_step_chunk(
            cfg, params, jnp.asarray(toks), js, jnp.asarray(lens),
            active=jnp.asarray(active))
        tl, ts, tok = tmodel.decode_step_chunk(
            tcfg, tparams, torch.from_numpy(toks), ts,
            torch.from_numpy(lens), active=torch.from_numpy(active))
        what = f"{arch} step {step}"
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4, err_msg=what)
        assert np.array_equal(tok.numpy(), np.asarray(jok)), what
        assert np.array_equal(ts.page_tables.numpy(),
                              np.asarray(js.page_tables)), what
        assert np.array_equal(ts.seq_lens.numpy(),
                              np.asarray(js.seq_lens)), what
        assert_pools_equal(js.pool, ts.pool, what)
        for pos, (jk, jv) in js.kv_pages.items():
            tk, tv = ts.kv_pages[pos]     # the port's sink page sliced off
            np.testing.assert_allclose(tk[:, :, :-1].numpy(), np.asarray(jk),
                                       atol=1e-4, rtol=1e-4, err_msg=what)
            np.testing.assert_allclose(tv[:, :, :-1].numpy(), np.asarray(jv),
                                       atol=1e-4, rtol=1e-4, err_msg=what)


def test_decode_step_chunk_matches_single_token():
    """The reference's model contract (tests/test_serving.py, olmo
    case) on the port: ragged chunks give token-by-token logits."""
    cfg, _, tcfg, tparams = _setup("olmo-1b")
    rng = np.random.RandomState(1)
    toks = torch.from_numpy(rng.randint(1, 255, (1, 2, 11)).astype(np.int32))
    s1 = t_empty(tcfg, 1, 2, 64, device="cpu")
    outs1 = []
    for t in range(11):
        lg, s1 = tmodel.decode_step(tcfg, tparams, toks[:, :, t], s1)
        outs1.append(lg)
    outs1 = torch.stack(outs1, dim=2)
    s2 = t_empty(tcfg, 1, 2, 64, device="cpu")
    outs2 = []
    for c0 in range(0, 11, 4):             # 11 = 4 + 4 + 3, ragged tail
        n = min(4, 11 - c0)
        chunk = torch.zeros((1, 2, 4), dtype=torch.int32)
        chunk[:, :, :n] = toks[:, :, c0:c0 + n]
        lg, s2, ok = tmodel.decode_step_chunk(
            tcfg, tparams, chunk, s2, torch.full((1, 2), n,
                                                 dtype=torch.int32))
        assert ok.all()
        outs2.append(lg[:, :, :n])
    outs2 = torch.cat(outs2, dim=2)
    np.testing.assert_allclose(outs1.numpy(), outs2.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(s1.seq_lens, s2.seq_lens)
    kv1, kv2 = s1.pool.classes[0], s2.pool.classes[0]
    assert torch.equal(kv1.private_top, kv2.private_top)
    assert torch.equal(kv1.shared.top, kv2.shared.top)


def test_pool_denial_appends_nothing():
    """A chunk whose pages cannot all be granted appends nothing and
    reports ok = False, in both packages alike."""
    cfg, params, tcfg, tparams = _setup("olmo-1b")
    js, ts = j_empty(cfg, 1, 1, 64), t_empty(tcfg, 1, 1, 64, device="cpu")
    kv = js.pool.classes[0]
    kv = kv._replace(private_top=jnp.zeros_like(kv.private_top),
                     shared=kv.shared._replace(top=jnp.zeros_like(
                         kv.shared.top)))
    js = js._replace(pool=js.pool._replace(classes=(kv,)))
    tkv = ts.pool.classes[0]
    tkv = tkv._replace(private_top=torch.zeros_like(tkv.private_top),
                       shared=tkv.shared._replace(top=torch.zeros_like(
                           tkv.shared.top)))
    ts = ts._replace(pool=ts.pool._replace(classes=(tkv,)))
    toks = np.ones((1, 1, 8), np.int32)
    _, js, jok = j_step_chunk(
        cfg, params, jnp.asarray(toks), js, jnp.full((1, 1), 8, jnp.int32))
    _, ts, tok = tmodel.decode_step_chunk(
        tcfg, tparams, torch.from_numpy(toks), ts,
        torch.full((1, 1), 8, dtype=torch.int32))
    assert not bool(tok[0, 0]) and not bool(jok[0, 0])
    assert int(ts.seq_lens[0, 0]) == 0
    assert (ts.page_tables == -1).all()
    assert_pools_equal(js.pool, ts.pool, "denied")


@pytest.mark.parametrize("arch", ["olmo-1b", "llama3.2-1b"])
def test_param_tree_matches_reference(arch):
    """The port's parameter tree has the reference's keys, shapes and
    dtypes: at full width from the definitions alone (nothing is
    allocated), and at smoke width from ``init_params``."""
    ref = jmodels.param_shapes(get_config(arch))
    port = tmodel.param_defs(t_get_config(arch))
    ref_flat = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
                for k, v in jax.tree_util.tree_leaves_with_path(ref)}

    def flat(tree, pre=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{pre}['{k}']"))
            return out
        return {pre: (tuple(tree.shape), str(tree.dtype)[len("torch."):])}

    assert flat(port) == ref_flat
    tcfg = t_smoke_config(t_get_config(arch))
    smoke_ref = jmodels.param_shapes(smoke_config(get_config(arch)))
    smoke = tmodel.init_params(tcfg, seed=0, device="cpu")
    assert flat(smoke) == {
        jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
        for k, v in jax.tree_util.tree_leaves_with_path(smoke_ref)}
    assert all(torch.isfinite(x).all() for x in smoke["embed"].values())


def test_slice_rejects_other_layer_kinds():
    with pytest.raises(NotImplementedError):
        tmodel.init_params(t_smoke_config(t_get_config("mamba2-370m")),
                           device="cpu")


@pytest.mark.parametrize("name", ["ln_nonparam", "rmsnorm", "apply_rope",
                                  "ffn_apply", "embed_apply",
                                  "logits_apply"])
def test_layer_matches_reference(name):
    """Each layer function of the port against the reference's on the
    same seeded inputs (f32, within 1e-5)."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    cfg, params, tcfg, tparams = _setup("llama3.2-1b")
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, cfg.d_model).astype(np.float32)
    toks = rng.randint(0, cfg.vocab, (2, 5)).astype(np.int32)
    ffn = params["groups"]["pos0"]["ffn"]
    tffn = tparams["groups"]["pos0"]["ffn"]
    sel = lambda tree: {k: v[0] for k, v in tree.items()}  # noqa: E731
    cases = {
        "ln_nonparam": (lambda: jl.ln_nonparam(jnp.asarray(x)),
                        lambda: tl.ln_nonparam(torch.from_numpy(x))),
        "rmsnorm": (lambda: jl.rmsnorm(jnp.asarray(x), jnp.asarray(x[0, 0])),
                    lambda: tl.rmsnorm(torch.from_numpy(x),
                                       torch.from_numpy(x[0, 0]))),
        "apply_rope": (
            lambda: jl.apply_rope(jnp.asarray(x.reshape(2, 5, 4, 16)),
                                  jnp.asarray(toks), cfg.rope_theta),
            lambda: tl.apply_rope(torch.from_numpy(x.reshape(2, 5, 4, 16)),
                                  torch.from_numpy(toks), cfg.rope_theta)),
        "ffn_apply": (lambda: jl.ffn_apply(cfg, sel(ffn), jnp.asarray(x)),
                      lambda: tl.ffn_apply(tcfg, sel(tffn),
                                           torch.from_numpy(x))),
        "embed_apply": (
            lambda: jl.embed_apply(params["embed"], jnp.asarray(toks)),
            lambda: tl.embed_apply(tparams["embed"], torch.from_numpy(toks))),
        "logits_apply": (
            lambda: jl.logits_apply(cfg, params["embed"], jnp.asarray(x)),
            lambda: tl.logits_apply(tcfg, tparams["embed"],
                                    torch.from_numpy(x))),
    }
    ref, port = cases[name]
    np.testing.assert_allclose(port().numpy(), np.asarray(ref()), atol=1e-5,
                               rtol=1e-5)


def test_bridge_keeps_bfloat16():
    """A bf16 leaf of the reference (numpy gives it as ml_dtypes'
    bfloat16) becomes a torch bf16 tensor with the same values."""
    from repro_torch.bridge import to_tensor
    a = jnp.asarray(np.random.RandomState(2).randn(3, 5), jnp.bfloat16)
    t = to_tensor(np.asarray(a), "cpu")
    assert t.dtype == torch.bfloat16 and t.shape == (3, 5)
    assert np.array_equal(t.float().numpy(), np.asarray(a, np.float32))
