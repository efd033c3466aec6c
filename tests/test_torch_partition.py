"""The port's partition rules and cell specs against the JAX package's.

``repro_torch.parallel.partition`` gives DTensor placements where the
reference gives ``PartitionSpec``s; ``repro_torch.launch.steps.
cell_specs`` builds each (arch x shape) cell's arguments as fake DTensor
shards on a fake process group of the production mesh.  The reference's
specs need no devices: its ``param_specs`` and ``cell_specs`` run on a
``jax.sharding.AbstractMesh`` of the same shape and axis names.

Held equal, on the 16 x 16 and 2 x 16 x 16 meshes:
* every parameter leaf's placements under each of the four rule sets;
* every argument leaf of every cell (the default rules of
  ``steps.py:216-222``, and each cell again under one of the four rule
  sets in turn): placements, dtype, rank 0's local shape (read
  off the fake DTensor), the donated arguments, and the per-device
  argument bytes, to the byte.  The port's decode state carries one
  sink page per shard in each KV-page leaf and one sink slot in each
  ring (``models/transformer.py::DecodeState``): those leaves are one
  longer on that dim, and the bytes differ by exactly the sinks'.  The
  port's AdamW step is a host int, counted as the reference's 4-byte
  int32 scalar;
* ``model_flops_for`` on every cell.
"""

import math
import os

import pytest

pytest.importorskip("torch")
import torch  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro import models as jmodels  # noqa: E402
from repro.configs import SHAPES as JSHAPES, get_config as jget  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.parallel import partition as jpart  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.parallel import partition  # noqa: E402

ARCHS = list_archs()
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
RULES = ("tp", "fsdp", "sp", "ep_serve")


def _ref_model_flops(cfg, shape):
    """The reference's ``launch/dryrun.py::model_flops_for``; its module
    sets XLA_FLAGS at import, which is put back."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun.model_flops_for(cfg, shape)


def _abstract(multi_pod):
    shape, names = MESHES[multi_pod]
    return AbstractMesh(shape, names)


def _placements(spec, ndim, names):
    """A reference ``PartitionSpec`` as DTensor placements, written out
    independently of the port's converter."""
    out = [Replicate()] * len(names)
    parts = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    for i, ax in enumerate(parts):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                out[names.index(a)] = Shard(i)
    return tuple(out)


def _key(entry) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    return str(entry)


def _ref_leaves(tree):
    """{path: leaf} of a JAX tree (None subtrees have no leaves)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(_key(e) for e in path): leaf for path, leaf in flat}


def _port_leaves(tree, prefix=()):
    """{path: leaf} of a port tree: ParamDef/TensorDef, placement tuples,
    DTensors and host ints are leaves."""
    if tree is None:
        return {}
    is_plc = (isinstance(tree, tuple) and tree
              and all(isinstance(p, (Shard, Replicate)) for p in tree))
    if partition.is_def(tree) or is_plc or not isinstance(
            tree, (dict, tuple, list)):
        return {"/".join(prefix): tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, prefix + (str(k),)))
    return out


_TORCH = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.int16): torch.int16}


def _sink_dim(path):
    """The dim a port decode-state leaf is one longer on (None: none)."""
    if "/kv_pages/" in "/" + path + "/":
        return 2
    if "/rings/" in "/" + path + "/":
        return 3
    return None


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch):
    """Every parameter leaf's placements, all four rule sets, both
    meshes."""
    cfg, jcfg = get_config(arch), jget(arch)
    for multi_pod in (False, True):
        names = MESHES[multi_pod][1]
        with make_production_mesh(multi_pod=multi_pod) as mesh:
            for rules in RULES:
                got = _port_leaves(partition.param_specs(
                    tmodel.param_defs(cfg), mesh, rules))
                ref = _ref_leaves(jpart.param_specs(
                    jmodels.param_defs(jcfg), _abstract(multi_pod), rules))
                assert set(got) == set(ref)
                shapes = _port_leaves(tmodel.param_defs(cfg))
                for path, spec in ref.items():
                    want = _placements(spec, len(shapes[path].shape), names)
                    assert got[path] == want, (rules, path)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_specs_equal_reference(arch, multi_pod):
    """Every cell's argument leaves: placements, dtype, local shape;
    donation; per-device argument bytes to the byte; at the default
    rules and again at one of the four rule sets a cell, in turn (every
    rule set on every mesh)."""
    cfg, jcfg = get_config(arch), jget(arch)
    names = MESHES[multi_pod][1]
    amesh = _abstract(multi_pod)
    sizes = dict(zip(names, MESHES[multi_pod][0]))
    cells = [(name, None) for name in SHAPES] + [
        (name, RULES[(k + multi_pod) % len(RULES)])
        for k, name in enumerate(SHAPES)]
    with make_production_mesh(multi_pod=multi_pod) as mesh:
        for shape_name, rules in cells:
            spec = steps.cell_specs(cfg, SHAPES[shape_name], mesh, rules)
            ref = jsteps.cell_specs(jcfg, JSHAPES[shape_name], amesh, rules)
            assert spec["donate_argnums"] == ref["donate_argnums"]
            ref_bytes = sink_bytes = 0
            for i in range(len(ref["args"])):
                r_defs = _ref_leaves(ref["args"][i])
                r_shard = _ref_leaves(ref["in_shardings"][i])
                p_defs = _port_leaves(spec["defs"][i])
                p_plc = _port_leaves(spec["placements"][i])
                p_args = _port_leaves(spec["args"][i])
                assert set(p_defs) == set(r_defs), (shape_name, i)
                for path, sds in r_defs.items():
                    d, plc, arg = p_defs[path], p_plc.get(path), p_args[path]
                    r_spec = r_shard[path].spec
                    want = _placements(r_spec, len(sds.shape), names)
                    local = list(sds.shape)
                    for j, ax in enumerate(tuple(r_spec)):
                        for a in (ax if isinstance(ax, tuple) else (ax,)):
                            if a is not None:
                                local[j] //= sizes[a]
                    itemsize = jnp.dtype(sds.dtype).itemsize
                    ref_bytes += math.prod(local) * itemsize
                    if not partition.is_def(d):    # the host AdamW step
                        assert sds.shape == () and d == 0 and plc is None
                        continue
                    assert plc == want, (shape_name, path)
                    assert d.dtype == _TORCH[jnp.dtype(sds.dtype)], path
                    shape = list(sds.shape)
                    k = _sink_dim(path) if i == 2 else None
                    if k is not None:
                        shape[k] += 1
                        local[k] += 1
                        sink_bytes += math.prod(local) // local[k] * itemsize
                    assert list(d.shape) == shape, (shape_name, path)
                    assert list(arg.to_local().shape) == local, path
            got = dryrun.arg_bytes(spec["defs"], spec["placements"], mesh)
            assert got == ref_bytes + sink_bytes, shape_name


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    for name in SHAPES:
        assert dryrun.model_flops_for(cfg, SHAPES[name]) == \
            _ref_model_flops(jcfg, JSHAPES[name])
        assert dryrun.cell_is_runnable(arch, name) == (
            name != "long_500k" or jcfg.supports_long)


def test_tuple_axis_shards_one_dim_over_both_mesh_dims():
    """("pod", "data") shards one tensor dim over pod, then data, and a
    dim that the axes do not divide stays whole."""
    with make_production_mesh(multi_pod=True) as mesh:
        plc = partition.data_spec(mesh, 3)
        assert plc == (Shard(0), Shard(0), Replicate())
        assert partition.dp_size(mesh) == 32
        assert partition.local_shape((64, 5, 7), plc, mesh) == (2, 5, 7)
        defn = tmodel.param_defs(get_config("whisper-tiny"))["embed"]["tok"]
        # whisper's vocabulary 51865 is no multiple of 16
        assert partition.spec_for(defn, partition.RULE_SETS["tp"], mesh) \
            == (Replicate(),) * 3


def test_constraints_are_identity_without_a_mesh():
    x = torch.randn(4, 3, 2)
    assert partition._ACTIVE_MESH is None
    assert partition.constrain_batch(x) is x
    assert partition.unshard(x, 0) is x
    assert partition.constant(x, x) is x
