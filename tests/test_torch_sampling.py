"""The port's sampler against the reference's.

* threefry bits and uniforms bit-identical to ``jax.random`` (jax 0.9,
  ``jax_threefry_partitionable`` on) over a grid of seeds and output
  positions, at olmo-1b's vocabulary and at the smoke vocabulary; the
  Gumbel noise within 1e-6 of max(1, |g|) (torch's ``log`` and XLA's
  differ in the last place on some inputs);
* ``sample_tokens`` and ``sample_lane`` against the reference's
  functions on the same logits: identical tokens, except where the
  reference's top-2 gap of ``logits / T + g`` is within 1e-5 of its
  scale (a near-tie that one ulp of noise can flip);
* the engines: the workload of ``tests/test_serving.py::
  test_sampling_determinism``, sampled streams under preemption
  (``tests/test_sched.py``) and under speculation
  (``tests/test_speculative.py``): tokens and status rows equal to the
  JAX engine's.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import _engine, assert_engines_equal, engine_setup
from repro.serving import sampling as js
from repro_torch.serving import sampling as ts

SEEDS = (0, 1, 42, -1, 2**31 - 1)
COUNTS = (0, 1, 7, 1000)
VOCABS = (50304, 256)
#: the Gumbel floats: one ulp of either log, relative to max(1, |g|)
GUMBEL_TOL = 1e-6
#: a token may differ only where the top-2 gap of the reference's
#: perturbed scores is within this fraction of their scale
NEAR_TIE = 1e-5


@pytest.fixture(scope="module")
def setup():
    return engine_setup("olmo-1b")


def _jkey(seed, count):
    return jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(0), jnp.int32(seed)), jnp.int32(count))


def _tkey(seed, count):
    return ts.request_key(torch.tensor(seed, dtype=torch.int32),
                          torch.tensor(count, dtype=torch.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniforms_bit_identical_to_jax(seed):
    tiny = jnp.finfo(jnp.float32).tiny
    for count in COUNTS:
        k1, k2 = _tkey(seed, count)
        key = _jkey(seed, count)
        for V in VOCABS:
            jb = np.asarray(jax.random.bits(key, (V,), jnp.uint32))
            assert np.array_equal(ts.random_bits(k1, k2, V).numpy(),
                                  jb.astype(np.int64)), (seed, count, V)
            ju = np.asarray(jax.random.uniform(key, (V,), jnp.float32,
                                               minval=tiny, maxval=1.0))
            tu = ts.uniform(k1, k2, V).numpy()
            assert np.array_equal(tu.view(np.int32), ju.view(np.int32))


def test_keys_batch_like_scalars():
    """A [2, 3] grid of (seed, count) keys equals the keys made one at a
    time (the engine draws every slot's noise in one call)."""
    seeds = torch.tensor([[0, 5, -1], [7, 2**31 - 1, 3]], dtype=torch.int32)
    counts = torch.tensor([[0, 1, 2], [1000, 4, 0]], dtype=torch.int32)
    k1, k2 = ts.request_key(seeds, counts)
    for i in range(2):
        for j in range(3):
            a, b = _tkey(int(seeds[i, j]), int(counts[i, j]))
            assert (int(k1[i, j]), int(k2[i, j])) == (int(a), int(b))


@pytest.mark.parametrize("V", VOCABS)
def test_gumbel_within_an_ulp_of_jax(V):
    worst = 0.0
    for seed in SEEDS:
        for count in COUNTS:
            jg = np.asarray(jax.random.gumbel(_jkey(seed, count), (V,),
                                              jnp.float32))
            tg = ts.gumbel(torch.tensor(seed, dtype=torch.int32),
                           torch.tensor(count, dtype=torch.int32), V).numpy()
            assert np.isfinite(tg).all()
            worst = max(worst, float(np.max(
                np.abs(tg - jg) / np.maximum(1.0, np.abs(jg)))))
    assert worst <= GUMBEL_TOL, worst


def _ref_scores(logits, temp, top_k, seeds, counts):
    """The reference's ``logits / T + g`` (after top-k) in numpy, with
    jax.random's Gumbel: the scores whose top-2 gap defines a near-tie."""
    V = logits.shape[-1]
    out = np.empty(logits.shape, np.float32)
    for idx in np.ndindex(*logits.shape[:-1]):
        row = jnp.asarray(logits[idx], jnp.float32)
        k = int(np.clip(top_k[idx[:2]], 1, V))
        kth = jnp.sort(row)[V - k]
        if top_k[idx[:2]] > 0:
            row = jnp.where(row < kth, -jnp.inf, row)
        g = jax.random.gumbel(_jkey(int(seeds[idx[:2]]), int(counts[idx])),
                              (V,), jnp.float32)
        t = max(float(temp[idx[:2]]), 1e-6)
        out[idx] = np.asarray(row / jnp.float32(t) + g)
    return out


def _near_tie(scores, temp, idx):
    """Is position idx's choice a near-tie (greedy: the logits'; sampled:
    the perturbed scores')?"""
    row = scores[idx]
    row = row[np.isfinite(row)]
    top = np.sort(row)[-2:]
    return top[1] - top[0] <= NEAR_TIE * max(1.0, np.abs(row).max())


def _registers(rng, shape, V):
    temp = np.where(rng.rand(*shape) < 0.25, 0.0,
                    rng.uniform(0.3, 1.5, shape)).astype(np.float32)
    top_k = rng.choice([0, 1, 5, V, V + 7], shape).astype(np.int32)
    seeds = rng.randint(-2**31, 2**31 - 1, shape).astype(np.int32)
    return temp, top_k, seeds


@pytest.mark.parametrize("V", VOCABS)
def test_sample_tokens_matches_the_reference(V):
    rng = np.random.RandomState(V)
    shape = (2, 4)
    logits = (rng.randn(*shape, V) * 3).astype(np.float32)
    temp, top_k, seeds = _registers(rng, shape, V)
    counts = rng.randint(0, 100, shape).astype(np.int32)
    want = np.asarray(js.sample_tokens(*map(jnp.asarray, (
        logits, temp, top_k, seeds, counts))))
    got = ts.sample_tokens(*map(torch.as_tensor, (
        logits, temp, top_k, seeds, counts))).numpy()
    assert got.dtype == np.int32 and got.shape == shape
    scores = _ref_scores(logits, temp, top_k, seeds, counts)
    for idx in zip(*np.nonzero(got != want)):
        assert temp[idx] > 0 and _near_tie(scores, temp, idx), idx
    # top-k 1 and greedy slots are argmax, whatever the noise
    sure = (temp <= 0) | (top_k == 1)
    assert np.array_equal(got[sure], logits.argmax(-1)[sure])


def test_sample_lane_matches_the_reference():
    rng = np.random.RandomState(1)
    V, T, shape = 256, 3, (2, 3)
    logits = (rng.randn(*shape, T, V) * 2).astype(np.float32)
    temp, top_k, seeds = _registers(rng, shape, V)
    counts = (rng.randint(0, 50, shape)[..., None]
              + np.arange(T)).astype(np.int32)
    want = np.asarray(js.sample_lane(*map(jnp.asarray, (
        logits, temp, top_k, seeds, counts))))
    got = ts.sample_lane(*map(torch.as_tensor, (
        logits, temp, top_k, seeds, counts))).numpy()
    scores = _ref_scores(logits, temp, top_k, seeds, counts)
    for idx in zip(*np.nonzero(got != want)):
        assert temp[idx[:2]] > 0 and _near_tie(scores, temp, idx), idx
    # position i draws with key counts[..., i]: the same token as a
    # one-position call at that count
    for i in range(T):
        one = ts.sample_tokens(*map(torch.as_tensor, (
            logits[:, :, i], temp, top_k, seeds, counts[..., i])))
        assert np.array_equal(one.numpy(), got[..., i])


# ------------------------------------------------------------- engines

def _sampled_reqs(Req, seed, temp=0.9, topk=8):
    return [Req(i, prompt=[3 + i, 5, 7, 11], max_new_tokens=6,
                temperature=temp, top_k=topk, seed=seed + i)
            for i in range(3)]


def _serve_both(setup, make, script=None, **kw):
    """``make(Req)`` requests through both engines (``script(eng,
    reqs)`` drives them, default submit-all then run); tokens, status
    rows, stats and the drain compared.  Returns the port's requests
    and engine."""
    out = {}
    for port in (False, True):
        eng, Req = _engine(setup, port, **kw)
        reqs = make(Req)
        if script is None:
            for r in reqs:
                eng.submit(r)
            eng.run(max_steps=300)
        else:
            script(eng, reqs)
        out[port] = eng, reqs
    (je, jr), (te, tr) = out[False], out[True]
    assert_engines_equal(je, jr, te, tr)
    return tr, te


def test_sampling_determinism_like_the_reference(setup):
    """tests/test_serving.py::test_sampling_determinism on both engines:
    equal streams, and the same seed / other seed / chunk / greedy
    properties."""
    def run(seed, temp=0.9, chunk=8, both=False):
        kw = dict(dp=1, b_local=2, max_len=64, chunk_size=chunk)
        if both:
            reqs, _ = _serve_both(
                setup, lambda Req: _sampled_reqs(Req, seed, temp), **kw)
        else:               # the port alone (each JAX engine compiles)
            eng, Req = _engine(setup, True, **kw)
            reqs = _sampled_reqs(Req, seed, temp)
            for r in reqs:
                eng.submit(r)
            eng.run(max_steps=300)
            assert all(r.done for r in reqs) and eng.leak_free()
        return [r.out_tokens for r in reqs]

    a = run(42, both=True)
    assert a == run(42)
    assert a != run(43)
    assert a == run(42, chunk=4)
    assert run(0, temp=0.0, both=True) == run(99, temp=0.0)


def test_sampled_streams_unchanged_under_preemption(setup):
    """tests/test_sched.py's preemption workload (a greedy and a sampled
    batch request, an interactive arrival that preempts one): equal to
    the JAX engine's, and equal to the run with room for all three."""
    def make(Req):
        return [Req(0, prompt=[2, 3, 4], max_new_tokens=10, slo="batch"),
                Req(1, prompt=[8, 9, 10], max_new_tokens=10, slo="batch",
                    temperature=0.9, top_k=8, seed=7),
                Req(2, prompt=[5, 6, 7], max_new_tokens=4,
                    slo="interactive")]

    def script(eng, reqs):
        eng.submit(reqs[0])
        eng.submit(reqs[1])
        for _ in range(3):
            eng.step()
        eng.submit(reqs[2])
        eng.run(max_steps=300)

    tight, eng = _serve_both(setup, make, script, dp=1, b_local=2,
                             max_len=64, chunk_size=8)
    assert eng.stats["preemptions"] >= 1
    eng, Req = _engine(setup, True, dp=1, b_local=3, max_len=64,
                       chunk_size=8)
    roomy = make(Req)
    script(eng, roomy)
    assert eng.stats["preemptions"] == 0
    assert [r.out_tokens for r in tight] == [r.out_tokens for r in roomy]


SPEC_PROMPT = [int(t) for t in np.random.RandomState(5).randint(1, 255, 16)]


def _spec_reqs(Req):
    return [Req(0, prompt=list(SPEC_PROMPT), max_new_tokens=6,
                temperature=0.9, top_k=12, seed=7)]


@pytest.fixture(scope="module")
def plain_sampled(setup):
    """The sampled stream of the speculation workload without drafts,
    equal on both engines."""
    plain, _ = _serve_both(setup, _spec_reqs, dp=1, b_local=1, max_len=64,
                           prefix_sharing=True, speculate=False)
    return plain[0].out_tokens


@pytest.mark.parametrize("cont", ["true", "partial"])
def test_sampled_speculation_like_the_reference(setup, plain_sampled, cont):
    """tests/test_speculative.py's sampled lanes: recording the true
    sampled continuation (every draft accepted) or its first 3 tokens
    then garbage (a partial accept) leaves the stream of the plain run,
    on both engines alike."""
    prompt, make, ref = SPEC_PROMPT, _spec_reqs, plain_sampled
    drafts = tuple(ref) if cont == "true" else tuple(ref[:3]) + tuple(
        (t + 55) % 254 + 1 for t in ref[3:5])

    def script(eng, reqs):
        key = eng.spec_store.key_of(prompt)
        eng.spec_store.record(key, tuple(prompt[len(key):]) + drafts)
        eng.submit(reqs[0])
        eng.run(max_steps=300)

    spec, eng = _serve_both(setup, make, script, dp=1, b_local=1,
                            max_len=64, prefix_sharing=True, speculate=True,
                            draft_len=4, spec_gate=False)
    assert eng.stats["spec_accepted"] > 0
    assert spec[0].out_tokens == ref
