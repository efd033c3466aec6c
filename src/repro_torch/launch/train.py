"""The trainer: the fault-tolerant train loop of the port.

Counterpart of the JAX package's ``launch/train.py``, with the same
flags and ``--device`` (``cuda`` unless ``cpu`` is asked for).  Each
step is :func:`build_step`'s function: the loss and its gradients by
autograd (global attention layers through K6; SSD and RG-LRU layers,
mamba2-370m's and recurrentgemma-2b's, through their full-sequence
forms in torch ops, as the reference differentiates its jnp forms),
optional int8 gradient compression, and an in-place AdamW update; the
loop around it is
:class:`repro_torch.runtime.fault.FaultTolerantLoop` (periodic async
checkpoints in the reference's npz layout, restart on failure,
straggler watchdog).  A step reads one number back from the card: the
loss, which :func:`main` records.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 20 --ckpt-dir build/ckpt_smoke
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --smoke --device cpu --steps 6 --ckpt-dir build/ckpt_mamba2

A checkpoint directory that already holds a complete checkpoint is
resumed from, a JAX trainer's included.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from ..checkpoint.ckpt import Checkpointer
from ..configs import get_config, smoke_config
from ..data.pipeline import DataConfig, TokenStream
from ..models.layers import tree_leaves, tree_map
from ..models.model import init_params, loss_fn
from ..optim import adamw
from ..parallel import compress
from ..runtime.fault import FailureInjector, FaultTolerantLoop

#: inside the checkout, under the build directory that git ignores
DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def build_step(cfg, opt_cfg, use_compression: bool = False):
    """``train_step(state, batch) -> (state, metrics)`` with state
    (params, AdamWState, EFState or None) and batch {"tokens",
    "labels"} int tensors on the parameters' device.  The parameters,
    moments and master copies are updated in place; ``metrics["loss"]``
    is a tensor on the device (reading it is the caller's choice)."""
    def train_step(state, batch):
        params, opt_state, ef = state
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(cfg, params, batch)
        grads = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(grads), params)
        if use_compression:
            grads, ef = compress.compressed_grads(grads, ef)
        params, opt_state, metrics = adamw.apply(opt_cfg, opt_state, grads,
                                                 params)
        metrics["loss"] = loss.detach()
        return (params, opt_state, ef), metrics

    return train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    opt_cfg = adamw.AdamWConfig(warmup_steps=10, decay_steps=args.steps)

    params = init_params(cfg, seed=0, device=args.device)
    opt_state = adamw.init(params)
    ef = compress.init_error_feedback(params) if args.compress_grads else None

    stream = TokenStream(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    step_fn = build_step(cfg, opt_cfg, args.compress_grads)
    losses = []

    def wrapped_step(state, batch):
        new_state, metrics = step_fn(state, {
            k: torch.from_numpy(a).to(args.device) for k, a in batch.items()})
        losses.append(float(metrics["loss"]))
        return new_state

    injector = None
    if args.inject_failure_at is not None:
        injector = FailureInjector(
            fail_at={args.inject_failure_at: RuntimeError("injected")})

    loop = FaultTolerantLoop(
        wrapped_step, stream.batch_at,
        Checkpointer(args.ckpt_dir), save_every=args.save_every,
        injector=injector)
    t0 = time.time()
    state = loop.run((params, opt_state, ef), args.steps)
    dt = time.time() - t0
    print(f"trained {loop.stats.completed_steps} steps in {dt:.1f}s "
          f"({loop.stats.restarts} restarts, "
          f"{loop.stats.straggler_steps} straggler steps)")
    if losses:
        print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
    return state, losses


if __name__ == "__main__":
    main()
