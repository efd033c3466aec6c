"""The port's DP allocation plane: one rank per DP shard.

Two ``gloo`` ranks on the CPU (``tests/_torch_mesh_rank.py``, spawned
processes that import the port alone and join through a file under the
test's temporary directory) serve olmo-1b's and mixtral-8x7b's smoke
configs through ``ServingEngine(mesh=group)``, while this process runs
the reference (and the port's single-process engine) on the same
inputs.  Held: (a) the DP axis of every ``DecodeState`` leaf equals the
reference's ``serve_state_pspecs``, and ``shard_state`` /
``gather_state`` round-trip; (b) greedy serving at dp 2 equals the
reference's ``ServingEngine(dp=2, mesh=None)``: tokens, every step's
status rows, each shard's integer state; (c) a storm with sharing,
speculation, pins and preemption keeps each shard conserved and
never-dry after every step and the ranks' host state identical, with
the single-process engine's tokens, and a request submitted after an
idle gap longer than its deadline is served; (d) one device-to-host
read and one collective a serve step, one agreement a share step; (e) expert paging
at dp 2 equals the resident engine on the same batches, 0 drops, the
budget held on each shard; (f) ``launch.serve.main`` on the ranks
prints the single-process run's lines and serves its streams.

The ranks of one spawn run all their scenarios in turn and are killed,
failing the tests, if they outlast ``RANK_LIMIT_S``.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import dataclasses

import numpy as np
import torch

import _torch_helpers  # noqa: F401  (caps torch's CPU threads)
import _torch_mesh_rank as rank_mod
from _torch_helpers import engine_setup, pool_leaves
from repro.launch.steps import serve_state_pspecs
from repro.models.decode_init import empty_decode_state as j_empty
from repro.serving import engine as jengine
from repro.serving.telemetry import FlightRecorder as JFlight
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.parallel import partition
from repro_torch.models.decode_init import empty_decode_state as t_empty
from repro_torch.models.transformer import EXPERT_PPE, expert_layer_slots
from repro_torch.runtime import elastic as telastic

RANK_LIMIT_S = 120
DP = 2
SERVE_ARGV = ["--arch", "olmo-1b", "--smoke", "--requests", "10",
              "--max-new", "4", "--dp", "2", "--b-local", "2",
              "--pin-pages", "8", "--hot-prefix", "8", "--speculate",
              "--no-spec-gate", "--repeat-frac", "0.3", "--device", "cpu"]


def _storm(seed=7):
    """A seeded script of submissions and steps: a hot 16-token prefix
    on most prompts, standard requests filling the slots, interactive
    ones arriving to preempt them."""
    rng = np.random.RandomState(seed)
    hot = [int(t) for t in rng.randint(1, 255, 16)]
    script, rid = [], 0
    for wave, (n, slo) in enumerate(((5, "standard"), (3, "interactive"),
                                     (4, "standard"), (2, "interactive"))):
        for _ in range(n):
            tail = [int(t) for t in rng.randint(1, 255, rng.randint(1, 12))]
            prompt = hot + tail if rng.rand() < 0.75 else tail + [3] * 4
            script.append(("submit", rid, prompt, int(rng.randint(3, 9)),
                           slo))
            rid += 1
        script.append(("step", int(rng.randint(2, 6))))
    return script


def _prompts(n=9, seed=42):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, 255, rng.randint(2, 29))]
            for _ in range(n)]


def _cf64(c):
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=64.0))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the two ranks on every scenario, compute this process's
    side meanwhile, and hand both over."""
    tmp = tmp_path_factory.mktemp("mesh")
    olmo = engine_setup("olmo-1b")
    mix = engine_setup("mixtral-8x7b")
    torch.save(olmo[3], tmp / "olmo.pt")
    torch.save(mix[3], tmp / "mixtral.pt")
    budget = EXPERT_PPE * expert_layer_slots(_cf64(mix[2])) * 2
    rng = np.random.RandomState(3)
    job = dict(
        dp=DP, init=str(tmp / "pg"), out=str(tmp),
        scenarios=["greedy", "idle_gap", "storm", "counts", "experts",
                   "serve"],
        olmo=str(tmp / "olmo.pt"), mixtral=str(tmp / "mixtral.pt"),
        prompts=_prompts(), storm=_storm(),
        storm_sched=dict(pin_pages=8, pin_rows=4),
        moe_prompts=[[int(t) for t in rng.randint(1, 255, 6)]
                     for _ in range(8)],
        expert_budget=budget,
        serve_argv=SERVE_ARGV + ["--mesh", "auto", "--dist-backend", "gloo"])
    return (*rank_mod.spawn(tmp, job, lambda: _this_side(olmo, job),
                            RANK_LIMIT_S), job)


def _this_side(olmo, job):
    """The reference's greedy run, and the port's single-process runs of
    the storm and of ``launch.serve.main``."""
    cfg, params, tcfg, tparams = olmo
    import itertools
    clock = itertools.count()
    je = jengine.ServingEngine(
        cfg, params, dp=DP, b_local=2, max_len=64, prefix_sharing=False,
        speculate=False, spec_gate=False, mesh=None,
        flight=JFlight(capacity=4096), clock=lambda: float(next(clock)))
    jr = [jengine.Request(i, prompt=list(p), max_new_tokens=4)
          for i, p in enumerate(job["prompts"])]
    for r in jr:
        je.submit(r)
    je.run(max_steps=500)
    storm = rank_mod.scenario_storm(None, job)
    made, base = [], tserve.Request

    def request(*a, **kw):
        made.append(base(*a, **kw))
        return made[-1]

    tserve.Request = request
    import contextlib
    import io
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            tserve.main(SERVE_ARGV)
    finally:
        tserve.Request = base
    return dict(je=je, jr=jr, storm=storm, serve_out=out.getvalue(),
                serve_tokens=[r.out_tokens for r in made])


# ------------------------------------------------------------------ (a)

def _axes_of(tree):
    """{path: DP axis} of a reference PartitionSpec tree or a port axis
    tree, named tuples' leaves by field name."""
    from jax.sharding import PartitionSpec as P
    out = {}

    def walk(path, x):
        if x is None:
            return
        if isinstance(x, P):
            out[path] = list(x).index("dp")
        elif isinstance(x, int):
            out[path] = x
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(path + (k,), x[k])
        elif hasattr(x, "_fields"):
            for k in x._fields:
                walk(path + (k,), getattr(x, k))
        else:
            for i, v in enumerate(x):
                walk(path + (i,), v)
    walk((), tree)
    return out


@pytest.mark.parametrize("arch,size_classes,expert", [
    ("olmo-1b", 1, False), ("recurrentgemma-2b", 2, False),
    ("mamba2-370m", 2, False), ("whisper-tiny", 2, False),
    ("mixtral-8x7b", 3, True)])
def test_state_axes_match_the_reference_pspecs(arch, size_classes, expert):
    """Every DecodeState leaf's DP axis equals the reference's
    PartitionSpec, leaf for leaf; ``shard_state`` cuts DP shard d out of
    a whole state and a one-rank ``gather_state`` of shards puts it back
    bit for bit."""
    from repro.configs import get_config, smoke_config
    from repro_torch.configs import get_config as tg, smoke_config as ts
    cfg, tcfg = smoke_config(get_config(arch)), ts(tg(arch))
    kw = dict(chunk=4, size_classes=size_classes,
              expert_budget=(EXPERT_PPE * expert_layer_slots(tcfg)
                             * tcfg.moe.num_experts if expert else None))
    jstate = j_empty(cfg, 3, 2, 32, **kw)
    tstate = t_empty(tcfg, 3, 2, 32, device="cpu", **kw)
    ref = _axes_of(serve_state_pspecs(jstate))
    got = _axes_of(tsteps.serve_state_axes(tstate))
    assert got == ref and len(got) >= 7
    assert tsteps.SERVE_REGISTER_AXIS == 0

    # distinct values everywhere, so a wrong axis or order shows
    g = torch.Generator().manual_seed(0)
    whole = partition.tree_map_defs(lambda t: torch.randint(
        -100, 100, t.shape, generator=g).to(t.dtype), tstate)
    shards = [tsteps.shard_state(whole, d) for d in range(3)]
    for sh in shards:
        for t, a in zip(_leaves(sh), _leaves(tsteps.serve_state_axes(sh))):
            assert t.shape[a] == 1

    class Stacked:
        """A stand-in group over the three shards: gather_state asks for
        the leaves in order, and each comes back from every shard."""
        calls = 0

        def gather(self, t, axis):
            k = self.calls
            self.calls += 1
            assert _leaves(shards[0])[k] is t
            return torch.cat([_leaves(s)[k] for s in shards], axis)

    back = tsteps.gather_state(shards[0], Stacked())
    assert all(torch.equal(a, b) for a, b in zip(_leaves(back),
                                                 _leaves(whole)))


def _leaves(tree):
    out = []
    partition.tree_map_defs(lambda t: out.append(t), tree)
    return out


def test_host_plans_match_the_reference():
    """``plan_for`` and ``nearest_mesh_for``, carried over host-only."""
    from repro.launch.mesh import nearest_mesh_for as j_nearest
    from repro.runtime.elastic import plan_for as j_plan
    for n in (1, 3, 8, 12, 16, 48, 256, 512):
        for pods in (1, 2):
            assert dataclasses.astuple(telastic.plan_for(n, pods=pods)) == \
                dataclasses.astuple(j_plan(n, pods=pods))
        assert tmesh.nearest_mesh_for(n) == j_nearest(n)
    from repro_torch.configs.base import SHAPES
    assert tsteps.decode_layout(SHAPES["decode_32k"], 16) == (16, 8)
    assert tsteps.decode_layout(SHAPES["long_500k"], 16) == (1, 1)


def test_groups_are_explicit():
    """A group's backend and device are the caller's: nccl refuses CPU
    ranks and (on a host with fewer cards than ranks) ranks sharing a
    card; the engine takes a DPGroup or nothing, of the right size."""
    with pytest.raises(ValueError):
        tmesh.DPGroup(0, 2, "cpu", "nccl")
    with pytest.raises(ValueError):
        tmesh.DPGroup(0, 2, "cpu", "mpi")
    with pytest.raises((RuntimeError, ValueError)):
        tmesh.make_dp_group(2, "nccl", "cuda")
    with pytest.raises(ValueError):
        tmesh.make_dp_group(2, "smoke-signals", "cpu")
    _, _, tcfg, tparams = engine_setup("olmo-1b")
    from repro_torch.serving.engine import ServingEngine
    with pytest.raises(TypeError):
        ServingEngine(tcfg, tparams, dp=2, b_local=1, max_len=32,
                      device="cpu", mesh="auto")
    with pytest.raises(ValueError):
        ServingEngine(tcfg, tparams, dp=4, b_local=1, max_len=32,
                      device="cpu", mesh=tmesh.DPGroup(0, 2, "cpu", "gloo"))


# --------------------------------------------------------------- (b)-(f)

def _shard_int_state(je, d):
    st = je.state
    return dict(page_tables=np.asarray(st.page_tables)[d:d + 1],
                seq_lens=np.asarray(st.seq_lens)[d:d + 1],
                pool=[x[d:d + 1] for x in pool_leaves(st.pool)])


def test_greedy_ranks_equal_the_reference(run):
    """(b) Tokens, the status rows of every step (and the lane widths,
    drafts and active sets beside them) and each shard's free stacks,
    tops, refcounts, lanes, page tables and seq_lens equal the
    reference's ``ServingEngine(dp=2, mesh=None)``; rank d holds shard d
    and ``gather_state`` gives the whole: integer leaves exact, KV pages
    within 1e-4 of the largest |K| of the reference's (float32 in two
    frameworks), shard d's bit for bit rank d's own."""
    ranks, mine, _ = run
    je, jr = mine["je"], mine["jr"]
    want = [r.out_tokens for r in jr]
    jflight = [{k: rec[k] for k in ("T", "spec", "drafts", "status", "ctr",
                                    "rids")} for rec in je.flight.ring]
    for d, got in enumerate(r["greedy"] for r in ranks):
        assert all(got["done"]) and got["tokens"] == want
        assert len(got["flight"]) == len(jflight) == got["steps"]
        for s, (a, b) in enumerate(zip(jflight, got["flight"])):
            assert a == b, f"rank {d}, step {s}"
        ref = _shard_int_state(je, d)
        loc = got["local"]
        assert np.array_equal(loc["page_tables"], ref["page_tables"])
        assert np.array_equal(loc["seq_lens"], ref["seq_lens"])
        for i, (a, b) in enumerate(zip(ref["pool"], loc["pool"])):
            assert a.dtype == b.dtype and np.array_equal(a, b), (d, i)
        whole = got["whole"]
        assert np.array_equal(whole["page_tables"],
                              np.asarray(je.state.page_tables))
        for a, b in zip(pool_leaves(je.state.pool), whole["pool"]):
            assert np.array_equal(a, b)
        for pos, (k, v) in je.state.kv_pages.items():
            # the port's pages end in a write-sink page of its own
            k = np.asarray(k)
            np.testing.assert_allclose(
                got["whole_kv"][pos][0][:, :, :k.shape[2]], k, rtol=0,
                atol=1e-4 * np.abs(k).max())
            np.testing.assert_array_equal(got["whole_kv"][pos][0][:, d],
                                          got["local_kv"][pos][0][:, 0])
        assert got["transfers"] == got["collectives"] == got["steps"]
        assert got["leak_free"] and got["pages_in_use"] == 0
        assert got["occupancy"]["mesh_devices"] == DP
        assert got["occupancy"]["pages_peak_shard"] == \
            je.shard_occupancy()["pages_peak_shard"]
    assert ranks[0]["greedy"]["host"] == ranks[1]["greedy"]["host"]


def test_idle_gap_does_not_expire_a_new_request(run):
    """A request submitted after the engine idled for longer than its
    ``deadline_s`` is stamped with the agreed clock of its submission
    (rank 0's, gathered at the submit to the idle engine, though rank
    1's own clock reads 1000 s ahead) and served, not failed as
    ``"deadline"``.  Three clock-only gathers (construction and each
    submit to an idle engine), one status gather a serve step."""
    ranks, _, _ = run
    for r in ranks:
        got = r["idle_gap"]
        assert got["stamped"] == (100.0, 105.0)
        assert got["done"] == [True, True]
        assert got["rejected"] == [None, None]
        assert all(len(t) == 3 for t in got["tokens"])
        assert got["collectives"] == got["steps"] > 0
        assert got["syncs"] == 3
    assert ranks[0]["idle_gap"]["host"] == ranks[1]["idle_gap"]["host"]


def test_storm_keeps_shards_conserved_and_ranks_in_lockstep(run):
    """(c) After every step each rank's shard holds free + live ==
    pages_local and every lane >= ell; the ranks' host state (slot map,
    queues, feeds, pin ledger, trie, the gate's agreed step costs, the
    agreed clock, stats) is identical after every step; tokens equal the
    port's single-process dp=2 engine's; the storm really preempted,
    shared, pinned and drafted; leak-free after the pins are flushed."""
    ranks, mine, _ = run
    a, b = (r["storm"] for r in ranks)
    ref = mine["storm"]
    assert a["hosts"] == b["hosts"] and len(a["hosts"]) > 10
    for got in (a, b):
        assert got["bad"] == [] and got["done"] and got["leak_free"]
        assert got["tokens"] == ref["tokens"]
    assert a["preemptions"] > 0 and a["shares"] > 0 and a["pins"] >= 0
    assert a["pin_hits"] > 0 and a["drafted"] > 0 and a["gate_costs"] > 0


def test_one_transfer_and_one_collective_per_step(run):
    """(d) In the watched steps, with shares admitted inside them: each
    served step reads exactly one tensor to the host (the gathered
    status) and runs one all_gather; each share step one all_reduce (the
    agreed verdict) and one read of it; nothing else."""
    ranks, _, _ = run
    for r in ranks:
        got = r["counts"]
        steps, transfers, colls, agrees, shares = got["delta"]
        assert steps >= 3 and shares >= 1 and agrees == shares
        assert transfers == colls == steps
        assert sorted(got["reads"]) == sorted(["numpy"] * steps
                                              + ["item"] * shares)
        assert sorted(got["colls"]) == sorted(["all_gather"] * steps
                                              + ["all_reduce"] * shares)
        assert got["leak_free"] and got["shared"] >= shares
    assert ranks[0]["counts"]["tokens"] == ranks[1]["counts"]["tokens"]


def test_expert_paging_on_ranks(run):
    """(e) Expert-paged mixtral-8x7b smoke at dp 2 under a one-footprint
    budget a shard, three footprints in turn over two shards: the paged streams equal the resident engine's on the
    paged run's batches, 0 capacity drops, each shard's CLS_EXPERT pages
    within the budget after every step, loads and evictions on both
    shards, one transfer and one collective a step, leak-free after
    ``flush_experts``; the ranks' host state identical."""
    ranks, _, job = run
    for r in ranks:
        got = r["experts"]
        p, res = got["paged"], got["resident"]
        assert p["done"] and res["done"]
        assert p["tokens"] == res["tokens"]
        assert res["admitted"] == p["admitted"]
        assert p["over"] == [] and got["dropped"] == [0] * DP
        assert got["stats"]["expert_pages_resident_peak"] <= \
            job["expert_budget"]
        assert got["stats"]["expert_evictions"] > 0
        assert got["transfers"] == got["collectives"] == \
            got["stats"]["steps"]
        assert got["leak_free"]
    assert ranks[0]["experts"]["host"] == ranks[1]["experts"]["host"]


def test_serve_main_on_ranks(run):
    """(f) ``launch.serve.main --mesh auto --dist-backend gloo`` under a
    two-rank world serves the single-process ``--dp 2`` run's streams;
    rank 0 prints its lines (but the allocation plane and wall-clock
    lines), rank 1 prints nothing."""
    ranks, mine, _ = run
    lead, other = (r["serve"] for r in ranks)
    assert lead["done"] and other["done"]
    assert lead["tokens"] == other["tokens"] == mine["serve_tokens"]
    assert other["stdout"] == ""
    timing = ("allocation plane", "served ", "latency ")

    def lines(out):
        return [ln for ln in out.splitlines() if not ln.startswith(timing)]
    assert lines(lead["stdout"]) == lines(mine["serve_out"])
    assert lead["stdout"].startswith(f"allocation plane: {DP} ranks over "
                                     f"gloo")
    assert lead["collectives"] == lead["steps"] > 0
