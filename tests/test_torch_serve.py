"""The port's serving driver (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``) on the same argv, with the
reference's seed-0 weights bridged into the port: identical engine
stats and identical tokens for every request of the synthetic trace,
pins, preemption budget and interactive class included; with an
injected fault schedule, the same recoveries and the same clean drain.
The telemetry outputs are written and readable.  The expert flags are
held against the reference's ``main`` in
``tests/test_torch_expert_paging.py``.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import json

import jax
import numpy as np

import _torch_helpers  # noqa: F401  (caps torch's CPU threads)
from _torch_helpers import TIMING, run_main
from repro import models as jmodels
from repro.configs import get_config, smoke_config
from repro.launch import serve as jserve
from repro_torch.launch import serve as tserve
from repro_torch.serving.telemetry import parse_prom
from repro_torch.serving.trace import validate_chrome


@pytest.fixture(scope="module")
def jparams():
    cfg = smoke_config(get_config("olmo-1b"))
    return jax.tree.map(np.asarray,
                        jmodels.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("extra", [
    ["--pin-pages", "8", "--page-budget", "6", "--interactive-frac", "0.5",
     "--hot-prefix", "8"],
    ["--pin-pages", "4", "--interactive-frac", "0.25", "--hot-prefix", "16",
     "--dp", "1", "--b-local", "3", "--max-new", "6"],
    ["--hot-prefix", "16", "--repeat-frac", "0.5", "--speculate",
     "--no-spec-gate", "--chunk-buckets", "1,4", "--requests", "8"],
])
def test_main_matches_reference_main(jparams, monkeypatch, extra):
    argv = ["--smoke"] + extra
    je, jreqs = run_main(jserve, argv, monkeypatch)
    te, treqs = run_main(tserve, argv + ["--device", "cpu"], monkeypatch,
                      jparams)
    assert all(r.done for r in treqs) and len(treqs) == len(jreqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [r.slo for r in treqs] == [r.slo for r in jreqs]
    assert ({k: v for k, v in te.stats.items() if k not in TIMING}
            == {k: v for k, v in je.stats.items() if k not in TIMING})
    assert te.scheduler.stats == je.scheduler.stats
    assert te.shard_occupancy()["pages_peak_shard"] == \
        je.shard_occupancy()["pages_peak_shard"]
    keys = ("T", "spec", "drafts", "status", "ctr", "rids")
    assert [[r[k] for k in keys] for r in te.flight.ring] == \
        [[r[k] for k in keys] for r in je.flight.ring]
    assert te.host_transfers == te.stats["steps"]
    assert te.page_occupancy() == je.page_occupancy() == 0.0
    assert te.telemetry.never_dry_margin_min() == \
        je.telemetry.never_dry_margin_min() >= 0
    assert te.stats["pins_created"] >= ("--pin-pages" in extra)


FAULTS = ("shard_loss@3:post_admission:1,crash@6:post_sync:torn,"
          "poison@1:feed:3,error@4:feed,crash@8:dispatched:torn")


def test_fault_schedule_matches_reference_main(jparams, monkeypatch,
                                               capsys):
    """--inject-fault (every kind but the straggler, which sleeps) and
    --deadline-s at dp 2 with pins: the same [chaos] lines (faults fired,
    crashes, reconciles, a clean drain), the same recovered engine's
    stats and step records."""
    argv = ["--smoke", "--requests", "12", "--max-new", "4", "--dp", "2",
            "--b-local", "2", "--pin-pages", "8", "--deadline-s", "100",
            "--inject-fault", FAULTS]

    def chaos_lines():
        return [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("[chaos]")]

    je, _ = run_main(jserve, argv, monkeypatch)
    jlines = chaos_lines()
    te, _ = run_main(tserve, argv + ["--device", "cpu"], monkeypatch, jparams)
    tlines = chaos_lines()
    assert tlines == jlines and len(tlines) == 4
    assert "drained clean: 12 finished" in tlines[-1]
    assert ({k: v for k, v in te.stats.items() if k not in TIMING}
            == {k: v for k, v in je.stats.items() if k not in TIMING})
    keys = ("T", "spec", "status", "rids")
    assert [[r[k] for k in keys] for r in te.flight.ring] == \
        [[r[k] for k in keys] for r in je.flight.ring]
    assert te.lost_shards == {1} and te.leak_free()


def test_telemetry_outputs(jparams, monkeypatch, tmp_path):
    """--metrics-path, --trace-path and --flight-recorder write readable
    files: a Prometheus snapshot with the never-dry margin, a valid
    chrome trace, and a flight dump of the last steps."""
    monkeypatch.setattr(tserve, "install_signal_dump", lambda flight: None)
    prom, trace, flight = (tmp_path / n for n in ("m.prom", "t.json",
                                                  "f.json"))
    te, _ = run_main(tserve, [
        "--smoke", "--device", "cpu", "--requests", "6", "--max-new", "4",
        "--pin-pages", "8", "--hot-prefix", "8", "--metrics-path",
        str(prom), "--trace-path", str(trace), "--flight-recorder",
        str(flight), "--flight-sync", "4"], monkeypatch, jparams)
    m = parse_prom(prom.read_text())
    assert m["repro_never_dry_margin_min_all"][()] >= 0
    validate_chrome(json.loads(trace.read_text()))
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"submit", "admit", "finish", "pin", "unpin"} <= names
    dump = json.loads(flight.read_text())
    assert dump["reason"] == "periodic" and dump["records"]


def test_cuda_without_a_card_raises(monkeypatch):
    """The driver never falls back to the CPU: without a card it serves
    only when ``--device cpu`` is asked for."""
    monkeypatch.setattr(tserve.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tserve.main(["--smoke", "--requests", "1"])
