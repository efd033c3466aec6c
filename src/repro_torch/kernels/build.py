"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``*.cu`` source under the package's ``csrc/`` directories is
compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain
C interface; headers shared by several kernels live in
``kernels/csrc/``, headers shared by one kernel's sources beside them.
The libraries go to ``build/repro_torch_kernels/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of their source
and those headers, so an edited kernel is rebuilt and a built one is
reused.  :func:`load_all` starts one ``nvcc`` per
source, all at once.

Nothing here runs when a module is imported: the CPU tests import every
module of the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG.parents[1] / "build" / "repro_torch_kernels"
COMMON = PKG / "kernels" / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", f"-I{COMMON}"]

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


def _source(stem: str) -> Path:
    (src,) = PKG.glob(f"kernels/**/csrc/{stem}.cu")
    return src


def library(stem: str) -> Path:
    """Where ``csrc/<stem>.cu``'s shared library is (or will be) built:
    named by a hash of the source and its headers."""
    src = _source(stem)
    h = hashlib.sha256(src.read_bytes())
    for header in (sorted(COMMON.glob("*.cuh"))
                   + sorted(src.parent.glob("*.cuh"))):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def load(stem: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<stem>.cu``, compiled if it is not
    built yet."""
    lib = _loaded.get(stem)
    if lib is None:
        src, out = _source(stem), library(stem)
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


def resource_usage(stem: str) -> Dict[str, Dict[str, int]]:
    """Each kernel of ``stem``'s built library by its mangled name: its
    registers (``REG``), stack frame (``STACK``, where spilled registers
    go), local memory (``LOCAL``) and shared memory bytes, as
    ``cuobjdump --dump-resource-usage`` reads them from the library, so
    a library built by an earlier process is read alike."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "--dump-resource-usage",
                           str(library(stem))], capture_output=True,
                          text=True, check=True).stdout
    usage, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function (\S+?):(?:\s|$)", line)
        if m:
            name, line = m.group(1), line[m.end():]
        if name is not None and "REG:" in line:
            usage[name] = {k: int(v) for k, v in
                           re.findall(r"(\w+):(\d+)", line)}
            name = None
    return usage


def load_all(stems: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """:func:`load` for several kernels, their ``nvcc`` runs started
    together (each waits in its own thread; the first failure raises)."""
    with ThreadPoolExecutor(max_workers=max(len(stems), 1)) as pool:
        libs = list(pool.map(load, stems))
    return dict(zip(stems, libs))
