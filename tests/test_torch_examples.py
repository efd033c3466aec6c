"""The port's twins of the JAX package's examples
(``repro_torch.examples``) against the reference scripts in
``examples/`` on the CPU.

``allocator_showcase`` prints the reference's lines, line for line.
``quickstart``'s first two sections give the reference's objects (the
simulated allocator's line, the block pool's ids and free counts), and
the whole twin runs twice in a row (the reference's second run resumes
past its last step and raises).  ``serve_paged`` gives the reference's
tokens, stats, scheduler stats and ``[chaos]`` lines on the docstring's
argv sets and a fault schedule, the reference's seed-0 weights bridged
into the port.  ``train_fault_tolerant``'s own bar holds (run B equal
to run A after the injected failure, here bit for bit), and its run A
gives the losses of the reference trainer's ``main`` on the same argv.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import importlib.util
import pathlib
import runpy
import sys
import time
import types

import jax
import numpy as np

import _torch_helpers  # noqa: F401  (caps torch's CPU threads)
from _torch_helpers import TIMING, run_main
from repro import models as jmodels
from repro.configs import get_config, smoke_config
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.serving import engine as jengine
from repro_torch.bridge import params_from_numpy
from repro_torch.examples import (allocator_showcase, quickstart,
                                  serve_paged, train_fault_tolerant)
from repro_torch.launch import train as ttrain
from repro_torch.models.layers import tree_leaves
from repro_torch.serving import engine as tengine

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _bridged(arch):
    cfg = smoke_config(get_config(arch))
    return jax.tree.map(np.asarray,
                        jmodels.init_params(cfg, jax.random.PRNGKey(0)))


def test_allocator_showcase_prints_the_reference_lines(capsys):
    runpy.run_path(str(EXAMPLES / "allocator_showcase.py"))
    ref = capsys.readouterr().out.splitlines()
    allocator_showcase.main([])
    assert capsys.readouterr().out.splitlines() == ref
    assert len(ref) == 22 and ref[-1] == "showcase done."


def test_quickstart_sections_match_reference_and_rerun(tmp_path,
                                                      monkeypatch, capsys):
    """Sections 1 and 2 against the reference script (its training and
    serving sections stubbed), then the whole twin twice on the same
    checkpoint directory: the second run clears it and trains its 10
    steps again."""
    monkeypatch.setattr(jtrain, "main", lambda argv: None)
    monkeypatch.setattr(jserve, "main", lambda argv: None)
    g = runpy.run_path(str(EXAMPLES / "quickstart.py"))
    ref = capsys.readouterr().out.splitlines()
    argv = ["--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")]
    for _ in range(2):
        out = quickstart.main(argv)
        lines = capsys.readouterr().out.splitlines()
        assert lines[:2] == ref[:2] and lines[1] == out["allocator"]
        assert lines[3:5] == ref[3:5]
        assert np.array_equal(out["ids"], np.asarray(g["ids"]))
        assert out["freed"] == int(g["pool"].top) == 1024
        assert out["top"] == 1024 - len(out["ids"])
        assert len(out["losses"]) == 10 and lines[-1] == "quickstart done."
        assert out["engine"].page_occupancy() == 0.0


def _reference_serve_paged(argv, monkeypatch):
    """The reference script's ``main`` on ``argv`` (loaded from
    ``examples/serve_paged.py``); returns (its last engine, every
    request it built)."""
    spec = importlib.util.spec_from_file_location(
        "reference_serve_paged", EXAMPLES / "serve_paged.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    built, made = [], []
    base_engine, base_request = mod.ServingEngine, mod.Request

    def engine(*a, **kw):
        built.append(base_engine(*a, **kw))
        return built[-1]

    def request(*a, **kw):
        made.append(base_request(*a, **kw))
        return made[-1]

    monkeypatch.setattr(mod, "ServingEngine", engine)
    monkeypatch.setattr(mod, "Request", request)
    monkeypatch.setattr(sys, "argv", ["serve_paged.py"] + argv)
    mod.main()
    return built[-1], made


@pytest.fixture
def steady_clock(monkeypatch):
    """Both engines' step-cost clock held still: the speculation gate
    compares measured step costs, so it would decide by the wall clock
    otherwise; with every cost 0 it takes its cost model."""
    for mod in (jengine, tengine):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=time.time, perf_counter=lambda: 0.0))


@pytest.mark.parametrize("extra", [
    ["--hot-prefix", "24", "--pin-pages", "12", "--bursts", "3",
     "--interactive-frac", "0.25"],
    ["--hot-prefix", "24", "--speculate", "--draft-len", "4",
     "--chunk-buckets", "1,4,8"],
    ["--inject-fault",
     "crash@6:post_sync:torn,shard_loss@12:post_admission:1"],
])
def test_serve_paged_matches_reference(extra, monkeypatch, capsys,
                                       steady_clock):
    argv = ["--requests", "12"] + extra

    def chaos_lines():
        return [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[chaos]")]

    je, jreqs = _reference_serve_paged(argv, monkeypatch)
    jlines = chaos_lines()
    te, treqs = run_main(serve_paged, argv + ["--device", "cpu"],
                         monkeypatch, _bridged("olmo-1b"))
    tlines = chaos_lines()
    assert len(treqs) == len(jreqs) == 12
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    # a crash's recovery requeues copies of the in-flight requests
    assert all(r.done for r in treqs) or "--inject-fault" in extra
    assert ({k: v for k, v in te.stats.items() if k not in TIMING}
            == {k: v for k, v in je.stats.items() if k not in TIMING})
    assert te.scheduler.stats == je.scheduler.stats
    assert tlines == jlines
    assert len(tlines) == (3 if "--inject-fault" in extra else 0)
    if "--speculate" in extra:
        assert te.speculate and te.stats["spec_lanes"] == \
            je.stats["spec_lanes"]
    if "--pin-pages" in extra:
        assert te.stats["pins_created"] > 0


def test_train_fault_tolerant_is_exact_and_matches_reference(
        tmp_path, monkeypatch):
    """The twin's own bar (run B within 1e-5 of run A after the failure
    at step 15) on the reference's PRNGKey(0) weights, bridged; the two
    runs are bit-equal here.  Run A's losses against the reference
    trainer's on the same argv, at
    ``test_torch_train.py::test_main_matches_reference_main``'s
    tolerance (the first within 1e-4, the rest 1e-3 relative) over the
    steps before float32 noise grows: until the reference's own losses
    from its weights moved by one ulp each (random signs) first differ
    from its losses by 1e-4 of their size.  That floor reaches past
    1e-3 later (AdamW moves each weight by about the learning rate
    whatever its gradient's size, and a capacity drop or a router's
    choice flips at a near-tie), so there every loss is held within
    1e-2, the floor's order, as mixtral's gradients are
    (``test_moe_gradient_noise_floor``)."""
    jparams = _bridged("mixtral-8x7b")
    monkeypatch.setattr(ttrain, "init_params", lambda c, seed, device:
                        params_from_numpy(jparams, device))
    (a, la), (b, lb) = train_fault_tolerant.main(
        ["--device", "cpu", "--ckpt-root", str(tmp_path / "t")])
    for x, y in zip(tree_leaves(a[0]), tree_leaves(b[0])):
        assert x.dtype == y.dtype and bool((x == y).all())
    assert len(la) == 24 and len(lb) == 24 + 2
    assert lb[:15] == la[:15] and lb[15:] == la[13:]
    argv = ["--arch", "mixtral-8x7b", "--smoke", "--steps", "24",
            "--save-every", "6"]
    _, j_losses = jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "j")])
    rng = np.random.RandomState(0)
    nudged = jax.tree.map(lambda w: np.nextafter(w, np.where(
        rng.rand(*w.shape) < 0.5, -np.inf, np.inf).astype(np.float32)),
        jparams)
    monkeypatch.setattr(jmodels, "init_params", lambda c, k: jax.tree.map(
        jax.numpy.asarray, nudged))
    _, n_losses = jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "n")])
    assert len(j_losses) == len(n_losses) == 24
    floor = [abs(x - y) / abs(y) for x, y in zip(n_losses, j_losses)]
    quiet = next(i for i, f in enumerate(floor) if f >= 1e-4)
    assert quiet >= 3 and max(floor) > 1e-3, floor
    assert abs(la[0] - j_losses[0]) <= 1e-4 * abs(j_losses[0])
    np.testing.assert_allclose(la[:quiet], j_losses[:quiet], rtol=1e-3)
    np.testing.assert_allclose(la, j_losses, rtol=1e-2)


def test_examples_without_a_card_raise(monkeypatch):
    """No example falls back to the CPU by itself."""
    monkeypatch.setattr(quickstart.torch.cuda, "is_available",
                        lambda: False)
    for mod in (quickstart, serve_paged, train_fault_tolerant):
        with pytest.raises(RuntimeError, match="--device cpu"):
            mod.main([])
