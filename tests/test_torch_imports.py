"""The port imports neither jax nor the reference package."""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import os
import pathlib
import re
import subprocess
import sys

import _torch_helpers  # noqa: F401  (caps torch's CPU threads)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of these now fails
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")
             and sys.modules[m] is not None)
print(len(mods), bad)
print(" ".join(mods))
"""


def test_every_module_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    head, names = out.stdout.splitlines()
    n, bad = head.split(" ", 1)
    assert int(n) >= 20 and bad.strip() == "[]", out.stdout
    # the modules of the sampling and recovery slice, of the
    # expert-paged MoE slice, of the DP allocation plane, the faithful
    # layer, the dry run and the example twins are among them
    assert {"repro_torch.serving.sampling", "repro_torch.serving.chaos",
            "repro_torch.models.moe", "repro_torch.serving.expert_pages",
            "repro_torch.launch.mesh", "repro_torch.launch.steps",
            "repro_torch.runtime.elastic",
            "repro_torch.core.linearizability",
            "repro_torch.parallel.partition", "repro_torch.launch.dryrun",
            "repro_torch.launch.roofline", "repro_torch.launch.report",
            "repro_torch.core.scheduler", "repro_torch.core.baselines",
            "repro_torch.core.refpool",
            "repro_torch.core.kv_cache",
            "repro_torch.examples.quickstart",
            "repro_torch.examples.allocator_showcase",
            "repro_torch.examples.serve_paged",
            "repro_torch.examples.train_fault_tolerant"} <= set(
                names.split()), names


def test_sources_name_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in pat.finditer(f.read_text())]
    assert len(files) > 20 and not hits, hits
