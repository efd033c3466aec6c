"""Are the kernels that two checkouts build from one source the same
machine code?  Run on the machine with the CUDA toolkit:

    python3 tools/sass_diff.py --src /path/to/parent/src --src src \\
        --stem flash_attention_bwd_wgmma --match 'ILi(64|128)E'

Compiles ``csrc/<stem>.cu`` of each ``--src`` tree with the package's
own ``nvcc`` flags (each tree's shared headers on its include path)
into a directory under that tree's checkout, prints ``ptxas``'s
registers, shared memory and spills for each kernel whose mangled name
matches ``--match``, and holds their ``cuobjdump -sass`` listings,
function by function, equal across the trees.  Prints one line a
kernel and exits 1 if a listing or a register count differs, or if a
kernel is in one tree's build and not the other's.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def key(name: str) -> str:
    """A kernel's mangled name with its anonymous namespace's token,
    which nvcc derives from the file, written ``<anon>``."""
    m = re.match(r"_ZN(\d+)_GLOBAL__N_", name)
    if not m:
        return name
    tok = name[3:3 + len(m.group(1)) + int(m.group(1))]
    return name.replace(tok, "<anon>")


def build(src: Path, stem: str) -> tuple:
    """(ptxas's lines by kernel, SASS by kernel) of ``stem`` in the tree
    ``src``."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc

    pkg = src / "repro_torch"
    (cu,) = pkg.glob(f"kernels/**/csrc/{stem}.cu")
    flags = [f for f in NVCC_FLAGS if not f.startswith("-I")]
    out = src.parent / "build" / "sass_diff" / f"lib{stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [nvcc(), *flags, f"-I{pkg / 'kernels' / 'csrc'}", "-o", str(out),
         str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, check=False)
    if proc.returncode != 0:
        raise SystemExit(f"sass_diff: nvcc failed for {cu}:\n{proc.stdout}")
    ptxas, name = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            name = key(m.group(1))
        elif name and ("registers" in line or "spill" in line):
            ptxas.setdefault(name, []).append(
                re.sub(r"^ptxas info\s*:\s*", "", line.strip()))
    dump = subprocess.run(
        [shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump",
         "-sass", str(out)], capture_output=True, text=True, check=True)
    sass = {}
    for part in dump.stdout.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        # branch labels are numbered across the file: renumber them in
        # the order each function first names them
        labels = {}
        body = re.sub(r"\.L_x_\d+", lambda m: labels.setdefault(
            m.group(0), f".L_{len(labels)}"), body.split("\n\t\t..")[0])
        sass[key(name.strip())] = body.strip()
    return ptxas, sass


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a src directory (give two)")
    ap.add_argument("--stem", action="append", required=True,
                    help="a kernel source's stem (csrc/<stem>.cu)")
    ap.add_argument("--match", default=".",
                    help="a regex the mangled kernel names must match")
    args = ap.parse_args()
    if len(args.src) != 2:
        raise SystemExit("sass_diff: give --src twice")
    pat = re.compile(args.match)
    bad = 0
    for stem in args.stem:
        (pa, sa), (pb, sb) = (build(Path(s).resolve(), stem)
                              for s in args.src)
        names = sorted(n for n in set(sa) | set(sb) if pat.search(n))
        for name in names:
            same = name in sa and name in sb and sa[name] == sb[name]
            regs = pa.get(name) == pb.get(name)
            bad += not (same and regs)
            print(f"sass_diff: {stem} {name}: SASS "
                  f"{'identical' if same else 'DIFFERS'} "
                  f"({len(sa.get(name, '').splitlines())} lines); ptxas "
                  f"{'identical' if regs else 'DIFFERS'}: "
                  f"{' | '.join(pb.get(name, pa.get(name, [])))}")
        print(f"sass_diff: {stem}: {len(names)} kernels matching "
              f"{args.match!r} compared")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
