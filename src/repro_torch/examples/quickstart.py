"""Quickstart: the paper's allocator + the framework around it, in 2 min.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Twin of the JAX package's ``examples/quickstart.py``:

1. runs the *faithful* wait-free allocator under an adversarial scheduler
   and shows the O(1) worst-case step bound (Result 1),
2. allocates/frees KV pages through the device-side block pool,
3. trains a reduced olmo-1b for a few steps,
4. serves a few requests through the paged-KV continuous-batching engine.

Section 3's checkpoints go to ``--ckpt-dir`` (``build/quickstart_ckpt``),
cleared first: the trainer resumes from a checkpoint it finds, and the
loop saves at its last step, so a second run would resume past its end
and train nothing.
"""

from __future__ import annotations

import argparse
import random
import shutil

import torch

from ..core import (SimContext, WaitFreeAllocator, Scheduler, closed_loop,
                    check_alloc_history, block_pool)
from ..launch.serve import main as serve_main
from ..launch.train import main as train_main
from . import BUILD, need_device


def allocator_section() -> str:
    """Section 1: eight asynchronous processes of 300 operations each
    under the random scheduler; returns the printed line."""
    p = 8
    ctx = SimContext(p, seed=0)
    alloc = WaitFreeAllocator(ctx, shared_batches=4 * p)
    sched = Scheduler(seed=0)
    for pid in range(p):
        sched.add(pid, closed_loop(pid, alloc, 300, random.Random(pid)))
    sched.run("random")
    worst = max(op.steps for op in ctx.history if op.completed)
    return (f"  {len(ctx.history)} ops on {p} async processes; "
            f"worst-case steps/op = {worst} (constant), "
            f"violations = {len(ctx.violations)}, "
            f"linearizability errors = "
            f"{len(check_alloc_history(ctx.history))}")


def block_pool_section(device: str):
    """Section 2: eight pages from a 1,024-page pool on ``device`` and
    back; prints the reference's two lines and returns (ids, free after
    the allocation, free after the free)."""
    pool = block_pool.create(1024, device=device)
    pool, ids = block_pool.alloc(pool, torch.ones(8, dtype=torch.bool,
                                                  device=device))
    ids = ids.cpu().numpy()
    top = int(pool.top)
    print(f"  allocated pages {ids} in O(1) array ops; free = {top}/1024")
    pool = block_pool.free(pool, torch.from_numpy(ids).to(device))
    print(f"  freed; free = {int(pool.top)}/1024")
    return ids, top, int(pool.top)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ckpt-dir", default=str(BUILD / "quickstart_ckpt"),
                    help="section 3's checkpoints, cleared first")
    args = ap.parse_args(argv)
    need_device(args.device, "quickstart")

    print("=== 1. wait-free fixed-size allocate/free (Result 1) ===")
    line = allocator_section()
    print(line)

    print("=== 2. device block pool (paged-KV pages) ===")
    ids, top, freed = block_pool_section(args.device)

    print("=== 3. train a reduced olmo-1b ===")
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    _, losses = train_main(["--arch", "olmo-1b", "--smoke", "--steps", "10",
                            "--ckpt-dir", args.ckpt_dir,
                            "--device", args.device])

    print("=== 4. serve through the paged-KV engine ===")
    engine = serve_main(["--arch", "olmo-1b", "--smoke", "--requests", "6",
                         "--max-new", "5", "--device", args.device])
    print("quickstart done.")
    return dict(allocator=line, ids=ids, top=top, freed=freed,
                losses=losses, engine=engine)


if __name__ == "__main__":
    main()
