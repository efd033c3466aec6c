"""The dry run's tables from its JSONs: the summary and the roofline of
each mesh.

Counterpart of the JAX package's ``launch/report.py``, over the port's
JSONs (``launch/dryrun.py``; its ``trace_s`` in the reference's
"compile s" column).  Every figure is predicted at H100 data-sheet
constants (``launch/roofline.py``), not measured.

  PYTHONPATH=src python -m repro_torch.launch.report build/dryrun [fallback_dir]
"""

from __future__ import annotations

import json
import pathlib
import sys


def load(dirs):
    """Cells by (arch, shape, mesh); earlier dirs win over later ones."""
    cells = {}
    for d in reversed(dirs):
        for p in sorted(pathlib.Path(d).glob("*.json")):
            r = json.loads(p.read_text())
            cells[(r["arch"], r["shape"], r["mesh"])] = r
    return cells


def fmt(x):
    if x == 0:
        return "0"
    if x < 1e-3 or x >= 1e4:
        return f"{x:.2e}"
    return f"{x:.3f}" if x < 10 else f"{x:.1f}"


def table(cells, mesh):
    rows = ["| arch | shape | HBM/dev GB | t_compute s | t_memory s | "
            "t_coll s | bottleneck | useful FLOP frac | MFU bound |",
            "|" + "---|" * 9]
    for (arch, shape, m), r in sorted(cells.items()):
        if m != mesh:
            continue
        rf = r["roofline"]
        rows.append(
            f"| {arch} | {shape} | {r['hbm_per_device_gb']} | "
            f"{fmt(rf['t_compute_s'])} | {fmt(rf['t_memory_s'])} | "
            f"{fmt(rf['t_collective_s'])} | {rf['bottleneck']} | "
            f"{rf['useful_flop_fraction']:.3f} | {rf['mfu_bound']:.3f} |")
    return "\n".join(rows)


def dryrun_section(cells):
    ok_sp = sum(1 for k in cells if k[2] == "16x16")
    ok_mp = sum(1 for k in cells if k[2] == "2x16x16")
    lines = [f"Single-pod (16x16 = 256 GPUs) cells traced: {ok_sp}",
             f"Multi-pod (2x16x16 = 512 GPUs) cells traced: {ok_mp}", "",
             "| arch | shape | mesh | trace s | HBM/dev GB | "
             "largest collective |",
             "|" + "---|" * 6]
    for (arch, shape, m), r in sorted(cells.items()):
        rf = r["roofline"]
        lines.append(f"| {arch} | {shape} | {m} | {r['trace_s']} | "
                     f"{r['hbm_per_device_gb']} | "
                     f"{rf.get('largest_collective', '')[:60]} |")
    return "\n".join(lines)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cells = load(argv or ["build/dryrun"])
    print("## Dry-run summary (predicted at H100 data-sheet constants, "
          "not measured)\n")
    print(dryrun_section(cells))
    print("\n## Roofline (single-pod 16x16)\n")
    print(table(cells, "16x16"))
    print("\n## Roofline (multi-pod 2x16x16)\n")
    print(table(cells, "2x16x16"))


if __name__ == "__main__":
    main()
