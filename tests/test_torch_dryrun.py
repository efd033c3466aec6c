"""The port's dry run (``repro_torch.launch.dryrun``) at smoke width on a
fake 2 x 2 mesh: each cell's JSON record carries the reference's keys
(``trace_s`` for ``lower_s``/``compile_s``, ``graph_cost`` for
``xla_cost_analysis``), the traced flops grow linearly with depth (no
trip-count multiplier: Python loops unroll), remat's recompute is in the
train cell's trace, no process group outlives a cell, and
``launch/report.py`` prints its tables.  The sharded step itself runs
(on fake tensors): the boundaries of ``parallel/partition.py`` hold on
every rule set here."""

import copy
import dataclasses
import functools
import json

import pytest

pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, report  # noqa: E402
from repro_torch.launch.mesh import fake_mesh  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

KEYS = {"arch", "shape", "mesh", "chips", "rules", "mode", "trace_s",
        "memory", "hbm_per_device_gb", "graph_cost", "roofline"}


def _no_remat(fn, *args, use_reentrant=None):
    return fn(*args)


@functools.lru_cache(maxsize=None)
def _traced(arch, mode, rules, layers, remat, early_stop):
    from torch.utils.checkpoint import set_checkpoint_early_stop
    cfg = smoke_config(get_config(arch))
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = ShapeConfig(f"{mode}_s", 64, 4, mode)
    remat_fn = transformer.checkpoint
    try:
        if not remat:              # each layer group runs without remat
            transformer.checkpoint = _no_remat
        with set_checkpoint_early_stop(early_stop):
            return dryrun.run_cell(
                arch, shape, rules=rules, cfg=cfg,
                mesh_cm=fake_mesh((2, 2), ("data", "model")))
    finally:
        transformer.checkpoint = remat_fn


def _cell(arch, mode, rules=None, layers=None, remat=True, early_stop=True):
    """One smoke cell's record on a fake 2 x 2 mesh (B 4, S 64); each
    cell is traced once a session."""
    return copy.deepcopy(_traced(arch, mode, rules, layers, remat,
                                 early_stop))


@pytest.mark.parametrize("arch,mode,rules", [
    ("olmo-1b", "train", None), ("olmo-1b", "prefill", None),
    ("olmo-1b", "decode", None), ("mixtral-8x7b", "decode", "ep_serve"),
    ("mamba2-370m", "train", "sp")])
def test_run_cell_records_the_reference_keys(arch, mode, rules, tmp_path):
    r = _cell(arch, mode, rules)
    assert set(r) == KEYS
    assert r["mesh"] == "2x2" and r["chips"] == 4 and r["mode"] == mode
    assert r["rules"] == (rules or ("fsdp" if mode == "train" else "tp"))
    mem, rf = r["memory"], r["roofline"]
    assert mem["argument_size_in_bytes"] > mem["alias_size_in_bytes"] >= 0
    assert r["graph_cost"]["flops"] == rf["hlo_flops_per_device"] > 0
    assert rf["t_compute_s"] > 0 and rf["t_memory_s"] > 0
    assert rf["bottleneck"] in ("compute", "memory", "collective")
    assert sum(rf["coll_counts"].values()) > 0
    assert not dist.is_initialized()
    (tmp_path / "cell.json").write_text(json.dumps(r))


def test_flops_grow_linearly_with_depth():
    """The layers' traced flops at 4 layers are twice those at 2 (the
    cell's flops less those of the same cell with no layer: the
    embedding's and the last position's logits): the trace holds every
    layer, where the reference multiplies a scan body by its trip
    count."""
    f = {n: _cell("olmo-1b", "prefill", layers=n)["graph_cost"]["flops"]
         for n in (0, 2, 4)}
    assert f[2] == _cell("olmo-1b", "prefill")["graph_cost"]["flops"]
    assert f[4] - f[0] == 2 * (f[2] - f[0]) > 0


def test_remat_adds_the_forwards_share():
    """The train cell with remat traces each group's forward again in
    the backward: its flops exceed the cell without remat by the
    layers' forward flops (the prefill cell's, the same forward, less
    those with no layer), all of them when checkpoint's early stop is off;
    with it on (torch's default) the recompute stops after the last
    value the backward reads, short of the FFN's output projection."""
    layers_fwd = (_cell("olmo-1b", "prefill")["graph_cost"]["flops"]
                  - _cell("olmo-1b", "prefill", layers=0)["graph_cost"][
                      "flops"])                 # smoke olmo: 2 layers
    without = _cell("olmo-1b", "train", remat=False)["graph_cost"]["flops"]
    full = _cell("olmo-1b", "train", early_stop=False)["graph_cost"]["flops"]
    early = _cell("olmo-1b", "train")["graph_cost"]["flops"]
    assert full - without == layers_fwd > 0
    assert 0 < early - without < layers_fwd


def test_report_prints_its_tables(tmp_path, capsys):
    for n, mesh in enumerate(("16x16", "2x16x16")):
        r = _cell("olmo-1b", "prefill")
        r["mesh"] = mesh
        (tmp_path / f"c{n}.json").write_text(json.dumps(r))
    report.main([str(tmp_path)])
    out = capsys.readouterr().out
    assert "cells traced: 1" in out
    assert out.count("| olmo-1b | prefill_s |") == 4
    assert "not measured" in out
