"""Sharded checkpointing with atomic index and async save.

Counterpart of the JAX package's ``checkpoint/ckpt.py``, with the same
layout and key paths, so a checkpoint that the JAX trainer wrote
restores into the port and the other way round.

Layout: ``<dir>/step_<N>/``
  * ``shard_<k>.npz``  — flat {path: array} for this host's shard, the
    path the keys of nested dicts and the field names or indices of
    tuples, joined by ``/``; bfloat16 stored as float32 (lossless)
  * ``aux.json``       — an optional JSON sidecar (the serving plane's
    host ledgers for a warm restart), read back by ``restore_aux``
  * ``INDEX.json``     — written LAST (atomic rename), listing the
    shards; a checkpoint without INDEX, or without a shard file its
    INDEX lists, is incomplete and ignored on restore

Shards written by several processes (the ranks of a DP group) share
one step directory: each saves its own file with ``complete=False``,
and once every file has landed one of them writes the marker for all
with :meth:`Checkpointer.mark_complete`, so no marker names a step that
a shard cannot restore.

Saves never corrupt the previous checkpoint: every file is written to
a temporary name and renamed into place.  ``latest_step`` reports only
complete checkpoints, and ``gc`` keeps the newest ``keep``.  The copy
of the state to the host is made before :meth:`Checkpointer.save`
returns; async mode serializes it in a worker thread, so the caller may
go on updating its tensors in place.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bfloat16 (which numpy lacks) as float32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):          # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        pass
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = _to_numpy(tree)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten_into(tree: Any, flat: Dict[str, np.ndarray], prefix: str = ""):
    """A tree like ``tree`` with the arrays of ``flat``: new tensors on
    each leaf's device, in its dtype and shape."""
    if isinstance(tree, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(
            _unflatten_into(getattr(tree, k), flat, f"{prefix}{k}/")
            for k in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            _unflatten_into(v, flat, f"{prefix}{i}/")
            for i, v in enumerate(tree))
    if tree is None:
        return None
    arr = np.asarray(flat[prefix[:-1]]).reshape(tuple(tree.shape))
    return torch.as_tensor(arr, dtype=tree.dtype, device=tree.device)


class Checkpointer:
    def __init__(self, directory: str, shard_id: int = 0, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.shard_id = shard_id
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any, async_: bool = False,
             aux: Any = None, complete: bool = True) -> None:
        """Write this shard's file (and ``aux``'s sidecar); with
        ``complete`` also the completion marker, listing this shard
        alone.  A shard of several sets ``complete=False`` and leaves
        the marker to :meth:`mark_complete`."""
        flat = _flatten(state)
        if async_:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, aux, complete),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, aux, complete)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               aux: Any = None, complete: bool = True) -> None:
        d = self._step_dir(step)
        d.mkdir(parents=True, exist_ok=True)
        tmp_npz = d / f".shard_{self.shard_id}.npz.tmp"
        with open(tmp_npz, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp_npz, d / f"shard_{self.shard_id}.npz")
        if aux is not None:
            tmp_aux = d / ".aux.json.tmp"
            tmp_aux.write_text(json.dumps(aux, default=int))
            os.replace(tmp_aux, d / "aux.json")
        if complete:
            self._mark(d, step, [self.shard_id], sorted(flat),
                       aux is not None)

    def mark_complete(self, step: int, shards) -> None:
        """Write the completion marker of a step whose ``shards`` were
        saved with ``complete=False``, once each of their files has
        landed; a missing one raises and leaves the step incomplete."""
        d = self._step_dir(step)
        missing = [k for k in shards if not (d / f"shard_{k}.npz").exists()]
        if missing:
            raise FileNotFoundError(f"{d}: shard files {missing} missing; "
                                    f"step {step} stays incomplete")
        with np.load(d / f"shard_{self.shard_id}.npz") as npz:
            keys = sorted(npz.files)
        self._mark(d, step, list(shards), keys, (d / "aux.json").exists())

    def _mark(self, d: pathlib.Path, step: int, shards, keys,
              has_aux: bool) -> None:
        tmp = d / ".INDEX.tmp"
        tmp.write_text(json.dumps({
            "step": step,
            "shards": shards,
            "keys": keys,
            "aux": has_aux,
        }))
        os.replace(tmp, d / "INDEX.json")       # atomic completion marker
        self._gc()

    def _step_dir(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:08d}"

    def _complete(self, d: pathlib.Path) -> bool:
        """The step directory has its marker and every shard file the
        marker lists."""
        try:
            index = json.loads((d / "INDEX.json").read_text())
        except (FileNotFoundError, ValueError):
            return False
        return all((d / f"shard_{k}.npz").exists() for k in index["shards"])

    def _gc(self) -> None:
        done = sorted(p for p in self.dir.glob("step_*")
                      if self._complete(p))
        for p in done[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)

    # ---------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        """The newest complete step that holds this shard's file."""
        done = sorted(p for p in self.dir.glob("step_*")
                      if self._complete(p)
                      and (p / f"shard_{self.shard_id}.npz").exists())
        if not done:
            return None
        return int(done[-1].name.split("_")[1])

    def restore(self, step: int, like: Any) -> Any:
        d = self._step_dir(step)
        if not self._complete(d):
            raise FileNotFoundError(f"incomplete checkpoint {d}")
        if not (d / f"shard_{self.shard_id}.npz").exists():
            raise FileNotFoundError(f"{d} holds no file of shard "
                                    f"{self.shard_id}")
        with np.load(d / f"shard_{self.shard_id}.npz") as npz:
            flat = dict(npz)
        return _unflatten_into(like, flat)

    def restore_aux(self, step: int) -> Any:
        """The JSON sidecar saved with ``step`` (None if there is
        none)."""
        d = self._step_dir(step)
        if not self._complete(d):
            raise FileNotFoundError(f"incomplete checkpoint {d}")
        p = d / "aux.json"
        return json.loads(p.read_text()) if p.exists() else None
