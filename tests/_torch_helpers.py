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


def rglru_fan_in(cfg, params):
    """The reference's parameters of a model with RG-LRU layers
    (recurrentgemma-2b) with each normal-init leaf of the stacked
    ``groups`` rescaled from N(0, 1) / sqrt(n_groups) to N(0, 1) /
    sqrt(its own layer's fan-in); other models as they are.  The
    reference's ``init_tree`` takes a leaf's first dimension as its
    fan-in, the stacking axis for a stacked leaf: recurrentgemma's
    weights come out too large, its RG-LRU gates saturate and its
    float32 numbers are set by rounding
    (``test_torch_train.py::test_recurrent_gradient_noise_floor``)."""
    import jax
    import jax.numpy as jnp
    from repro.models.layers import is_def
    from repro.models.transformer import model_defs

    if "rglru" not in cfg.pattern:
        return params

    def scale(d, p):
        if d.init != "normal":
            return p
        return (p.astype(jnp.float32) * np.sqrt(d.shape[0] / d.shape[1])
                ).astype(p.dtype)

    groups = jax.tree.map(scale, model_defs(cfg)["groups"],
                          params["groups"], is_leaf=is_def)
    return {**params, "groups": groups}


def extra_inputs(cfg, rng, B):
    """A VLM's image patch embeddings ``img_embeds`` [B, img_tokens, d]
    or an encoder-decoder's frame embeddings ``enc_embeds`` [B, enc_len,
    d], float32 numpy from ``rng`` (empty for a decoder)."""
    if cfg.arch_kind == "vlm":
        return {"img_embeds": rng.randn(B, cfg.img_tokens, cfg.d_model)
                .astype(np.float32)}
    if cfg.arch_kind == "encdec":
        return {"enc_embeds": rng.randn(B, cfg.enc_len, cfg.d_model)
                .astype(np.float32)}
    return {}


def run_main(mod, argv, monkeypatch, jparams=None):
    """Run one package's serve ``main`` and keep every request it builds;
    ``jparams`` (numpy) replace the port's own draw, bridged."""
    from repro_torch.bridge import params_from_numpy

    made = []
    base = mod.Request

    def request(*a, **kw):
        made.append(base(*a, **kw))
        return made[-1]

    monkeypatch.setattr(mod, "Request", request)
    if jparams is not None:
        monkeypatch.setattr(mod, "init_params", lambda c, seed, device:
                            params_from_numpy(jparams, device))
    return mod.main(argv), made


# --------------------------------------------------- engine parity harness

#: counters that read the wall clock (the step watchdog)
TIMING = {"stragglers", "step_timeouts"}


def engine_setup(arch, **overrides):
    """(reference config, reference params, port config, bridged port
    params) of ``arch``'s smoke config with the fields ``overrides``
    replaced (the same ``dataclasses.replace`` on both packages'
    configs; a callable override gives the field's value from each
    package's smoke config, as ``moe=lambda c: dataclasses.replace(
    c.moe, num_experts=128)``), weights from PRNGKey(0)."""
    import dataclasses

    import jax
    from repro import models as jmodels
    from repro.configs import get_config, smoke_config
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.configs import smoke_config as t_smoke_config

    def replaced(c):
        return dataclasses.replace(c, **{
            k: v(c) if callable(v) else v for k, v in overrides.items()})

    cfg = replaced(smoke_config(get_config(arch)))
    params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = replaced(t_smoke_config(t_get_config(arch)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, tcfg, tparams


def _engine(setup, port, **kw):
    """One package's engine on ``setup`` with a counting clock and a
    flight ring long enough for a test's every step; returns (engine,
    its Request class).  The engine options ``kw`` go to both packages
    alike."""
    import itertools

    from repro.serving import engine as jengine
    from repro.serving.telemetry import FlightRecorder as JFlight
    from repro_torch.serving import engine as tengine
    from repro_torch.serving.telemetry import FlightRecorder as TFlight

    cfg, params, tcfg, tparams = setup
    clock = itertools.count()
    if port:
        return tengine.ServingEngine(
            tcfg, tparams, flight=TFlight(capacity=4096),
            clock=lambda: float(next(clock)), device="cpu",
            **kw), tengine.Request
    return jengine.ServingEngine(
        cfg, params, flight=JFlight(capacity=4096),
        clock=lambda: float(next(clock)), **kw), jengine.Request


def serve(setup, port, prompts, max_new, prepare=None, submit_at=None,
          **kw):
    """Run one workload through one package's engine; returns (engine,
    requests).  ``prepare(engine)`` runs before the first submission;
    ``submit_at[i]`` is the number of steps taken before request i is
    submitted (all at once by default)."""
    eng, Req = _engine(setup, port, **kw)
    if prepare is not None:
        prepare(eng)
    reqs = [Req(i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    submit_at = submit_at or [0] * len(reqs)
    for step in range(max(submit_at, default=0) + 1):
        for r, at in zip(reqs, submit_at):
            if at == step:
                eng.submit(r)
        if step < max(submit_at):
            eng.step()
    eng.run(max_steps=500)
    return eng, reqs


def drive(setup, port, script, **kw):
    """Run ``script`` through one package's engine:
    ``("submit", rid, prompt, max_new, slo)`` submits a request,
    ``("step", n)`` takes n steps, ``("run",)`` steps until idle.
    Returns (engine, requests in submission order)."""
    eng, Req = _engine(setup, port, **kw)
    reqs = []
    for op, *args in script:
        if op == "submit":
            rid, prompt, max_new, slo = args
            reqs.append(Req(rid, prompt=list(prompt),
                            max_new_tokens=max_new, slo=slo))
            eng.submit(reqs[-1])
        elif op == "step":
            for _ in range(args[0]):
                eng.step()
        else:
            eng.run(max_steps=500)
    return eng, reqs


def assert_engines_equal(je, jr, te, tr, drained=True):
    """Identical tokens, every step's packed status rows, counter
    blocks, lane widths, drafts and active sets, identical non-timing
    stats, per-shard telemetry and latencies, exactly one counted
    transfer per step; with ``drained``, a leak-free drain."""
    assert all(r.done for r in tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    jrec, trec = list(je.flight.ring), list(te.flight.ring)
    assert len(trec) == len(jrec) == te.stats["steps"]
    keys = ("T", "spec", "drafts", "status", "ctr", "rids")
    for s, (a, b) in enumerate(zip(jrec, trec)):
        assert [b[k] for k in keys] == [a[k] for k in keys], f"step {s}"
    assert ({k: v for k, v in te.stats.items() if k not in TIMING}
            == {k: v for k, v in je.stats.items() if k not in TIMING})
    assert te.telemetry.snapshot()["per_shard"] == \
        je.telemetry.snapshot()["per_shard"]
    assert te.latency_quantiles() == je.latency_quantiles()
    assert te.host_transfers == te.stats["steps"]
    if drained:
        assert te.page_occupancy() == je.page_occupancy() == 0.0
        assert te.leak_free()


def assert_same(setup, prompts, max_new, **kw):
    """The port's engine against the reference's on one workload (see
    :func:`assert_engines_equal`).  Returns (port requests, port
    engine, reference engine)."""
    je, jr = serve(setup, False, prompts, max_new, **kw)
    te, tr = serve(setup, True, prompts, max_new, **kw)
    assert_engines_equal(je, jr, te, tr)
    return tr, te, je
