"""Fault-tolerant training demo: checkpoint/restart + failure injection.

Twin of the JAX package's ``examples/train_fault_tolerant.py``: trains
a reduced mixtral (MoE + SWA) twice, the second time with a node
failure injected at step 15; the loop restores from the last complete
checkpoint and reaches the state the failure-free run reaches (a pure
step function over a pure data stream).

  PYTHONPATH=src python -m repro_torch.examples.train_fault_tolerant \\
      [--device cpu]

The two runs' checkpoints go to ``<--ckpt-root>/a`` and ``/b``
(``build/ft``), cleared first.  ``main`` returns both runs' final
states and losses.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

from ..launch.train import main as train_main
from ..models.layers import tree_leaves
from . import BUILD, need_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ckpt-root", default=str(BUILD / "ft"),
                    help="the runs' checkpoints go to <root>/a and "
                         "<root>/b, cleared first")
    args = ap.parse_args(argv)
    need_device(args.device, "train_fault_tolerant")
    dirs = [str(Path(args.ckpt_root) / x) for x in ("a", "b")]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    common = ["--arch", "mixtral-8x7b", "--smoke", "--steps", "24",
              "--save-every", "6", "--device", args.device]

    print("=== run A: no failures ===")
    state_a, losses_a = train_main(common + ["--ckpt-dir", dirs[0]])

    print("=== run B: failure injected at step 15 ===")
    state_b, losses_b = train_main(common + ["--ckpt-dir", dirs[1],
                                             "--inject-failure-at", "15"])

    pa, pb = state_a[0], state_b[0]
    diffs = [float((a.detach().float() - b.detach().float()).abs().max())
             for a, b in zip(tree_leaves(pa), tree_leaves(pb))]
    print(f"max param diff after recovery vs failure-free: {max(diffs):.2e}")
    assert max(diffs) < 1e-5, "recovery must be bit-faithful"
    print("fault-tolerant recovery is exact.")
    return (state_a, losses_a), (state_b, losses_b)


if __name__ == "__main__":
    main()
