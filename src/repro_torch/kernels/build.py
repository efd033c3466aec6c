"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``*.cu`` source under the package's ``csrc/`` directories is
compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain
C interface.  The libraries go to ``build/repro_torch_kernels/`` at the
root of the checkout (listed in ``.gitignore``), named by a hash of
their source, so an edited kernel is rebuilt and a built one is reused.

Nothing here runs when a module is imported: the CPU tests import every
module of the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG.parents[1] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
#: nvcc's output for each source this process compiled (``-Xptxas -v``
#: prints registers and spills)
logs: Dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def load(stem: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<stem>.cu``, compiled if it is not
    built yet."""
    lib = _loaded.get(stem)
    if lib is None:
        (src,) = PKG.glob(f"kernels/**/csrc/{stem}.cu")
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{stem}-{digest}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src.name}:\n"
                                   f"{proc.stdout}")
            os.replace(tmp, out)
            logs[stem] = proc.stdout
        lib = _loaded[stem] = ctypes.CDLL(str(out))
    return lib
