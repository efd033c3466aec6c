"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step.

Counterpart of the JAX package's ``launch/dryrun.py``.  Each cell's
step (``launch/steps.py::cell_specs``) runs once over fake DTensor
shards on a fake process group of the production mesh
(``launch/mesh.py::make_production_mesh``: 16 x 16 = 256 or 2 x 16 x 16
= 512 ranks, this process rank 0), under ``aot_function`` with
compilers that record the graphs and never run them
(``launch/roofline.py::trace``).  Nothing touches a card: the dry run
has no device path, and the kernel wrappers take their plain versions
on the fake host tensors, as the reference's CPU dry run takes each
op's ``ref`` off the TPU.  Per cell it records the per-device argument
bytes (exact, from the local shards), the peak of the step's own
tensors (a liveness walk over the graphs) and the roofline terms at
H100 data-sheet constants, to JSON.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Keys that differ from the reference's: ``trace_s`` (the trace's
seconds) stands for ``lower_s`` and ``compile_s``; ``graph_cost`` (the
graphs' totals) for ``xla_cost_analysis``; ``memory`` holds the
argument bytes (in all and by argument), the peak temporary, output
and donated (``alias``) bytes.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback

from ..configs import SHAPES, get_config, list_archs
from ..configs.base import ShapeConfig
from ..models import model as model_mod
from ..parallel import partition
from . import roofline as rf
from . import steps as steps_mod
from .mesh import make_production_mesh

#: inside the checkout, under the build directory that git ignores
DEFAULT_OUT = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"


def cell_is_runnable(arch: str, shape_name: str) -> bool:
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.supports_long:
        return False   # sub-quadratic rule — see DESIGN.md
    return True


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D to train; 2*N*D to
    prefill; 2*N per sequence to decode a token."""
    n_active = model_mod.count_active_params(cfg)
    if shape.mode == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def arg_bytes(defs, plc, mesh) -> int:
    """Per-device bytes of a tree of argument TensorDefs under their
    placements: each leaf's local shard; a host int (the AdamW step)
    counts as the reference's 4-byte int32 scalar."""
    total = []

    def one(d, p):
        total.append(math.prod(partition.local_shape(d.shape, p, mesh))
                     * d.dtype.itemsize if partition.is_def(d) else 4)

    partition.tree_map_defs(one, defs, plc)
    return sum(total)


def _mesh_label(mesh) -> str:
    return "x".join(str(mesh.size(i)) for i in range(mesh.ndim))


def run_cell(arch: str, shape_name, multi_pod: bool = False,
             rules: str = None, save_graph: str = None, *, cfg=None,
             mesh_cm=None) -> dict:
    """Trace one cell and return its JSON record.  ``shape_name`` is a
    key of ``SHAPES`` or a ``ShapeConfig``; ``cfg`` overrides the
    arch's config, ``mesh_cm`` the production mesh (a context manager
    of ``launch/mesh.py``)."""
    cfg = cfg or get_config(arch)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    with (mesh_cm or make_production_mesh(multi_pod=multi_pod)) as mesh:
        chips = mesh.size()
        spec = steps_mod.cell_specs(cfg, shape, mesh, rules=rules)
        partition.set_activation_mesh(mesh,
                                      seq_shard=(spec["rules"] == "sp"))
        try:
            t0 = time.time()
            graphs = rf.trace(spec["fn"], spec["args"], spec["fake_mode"])
            t_trace = time.time() - t0
        finally:
            partition.set_activation_mesh(None)
        roof = rf.from_graphs(graphs, chips,
                              model_flops=model_flops_for(cfg, shape))
        cost = rf.add_costs([rf.analyze_graph(g) for g in graphs])
        by_arg = [arg_bytes(d, p, mesh)
                  for d, p in zip(spec["defs"], spec["placements"])]
        args_b = sum(by_arg)
        donated = sum(by_arg[i] for i in spec["donate_argnums"])
        temp_b = sum(rf.peak_temp_bytes(g) for g in graphs)
        out_b = sum(rf._nbytes(rf._val(a)) for g in graphs
                    for n in g.graph.nodes if n.op == "output"
                    for a in set(rf._arg_nodes(n)))
        label = _mesh_label(mesh)
    if save_graph:
        pathlib.Path(save_graph).write_text(
            "\n\n".join(g.print_readable(print_output=False)
                        for g in graphs))
    mem = {"argument_size_in_bytes": args_b,
           "argument_size_by_arg": by_arg,
           "temp_size_in_bytes": temp_b,
           "output_size_in_bytes": out_b,
           "alias_size_in_bytes": donated}
    return {
        "arch": arch, "shape": shape.name, "mesh": label, "chips": chips,
        "rules": spec["rules"], "mode": shape.mode,
        "trace_s": round(t_trace, 1),
        "memory": mem,
        "hbm_per_device_gb": round((args_b + temp_b - donated) / 2**30, 3),
        "graph_cost": {"flops": cost.flops + cost.flops_f32,
                       "bytes accessed": cost.bytes},
        "roofline": roof.as_dict(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--rules", default=None)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--save-graph", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    cells = []
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    for arch in archs:
        for shape in shapes:
            if not cell_is_runnable(arch, shape):
                print(f"SKIP {arch} x {shape} (sub-quadratic rule)")
                continue
            for mp in meshes:
                cells.append((arch, shape, mp))

    failures = 0
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
        if args.rules:
            tag += f"__{args.rules}"
        path = outdir / (tag + ".json")
        if args.skip_existing and path.exists():
            print(f"SKIP (exists) {tag}")
            continue
        print(f"=== {tag} ===", flush=True)
        try:
            res = run_cell(arch, shape, mp, rules=args.rules,
                           save_graph=args.save_graph)
            path.write_text(json.dumps(res, indent=2))
            r = res["roofline"]
            print(f"  ok: trace={res['trace_s']}s "
                  f"hbm/dev={res['hbm_per_device_gb']}GB "
                  f"t_comp={r['t_compute_s']:.2e} "
                  f"t_mem={r['t_memory_s']:.2e} "
                  f"t_coll={r['t_collective_s']:.2e} "
                  f"bottleneck={r['bottleneck']} "
                  f"mfu<={r['mfu_bound']:.2f}", flush=True)
        except Exception as e:       # a cell's failure is recorded, not fatal
            failures += 1
            path.with_suffix(".err").write_text(traceback.format_exc())
            print(f"  FAIL: {type(e).__name__}: {str(e)[:300]}", flush=True)
    print(f"done, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
