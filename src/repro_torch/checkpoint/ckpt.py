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
  * ``INDEX.json``     — written LAST (atomic rename); a checkpoint
    without INDEX is incomplete and ignored on restore

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
             aux: Any = None) -> None:
        flat = _flatten(state)
        if async_:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, aux), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, aux)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               aux: Any = None) -> None:
        d = self.dir / f"step_{step:08d}"
        d.mkdir(parents=True, exist_ok=True)
        tmp_npz = d / f".shard_{self.shard_id}.npz.tmp"
        with open(tmp_npz, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp_npz, d / f"shard_{self.shard_id}.npz")
        if aux is not None:
            tmp_aux = d / ".aux.json.tmp"
            tmp_aux.write_text(json.dumps(aux, default=int))
            os.replace(tmp_aux, d / "aux.json")
        tmp = d / ".INDEX.tmp"
        tmp.write_text(json.dumps({
            "step": step,
            "shards": [self.shard_id],
            "keys": sorted(flat),
            "aux": aux is not None,
        }))
        os.replace(tmp, d / "INDEX.json")       # atomic completion marker
        self._gc()

    def _gc(self) -> None:
        done = sorted(p for p in self.dir.glob("step_*")
                      if (p / "INDEX.json").exists())
        for p in done[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)

    # ---------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        done = sorted(p for p in self.dir.glob("step_*")
                      if (p / "INDEX.json").exists())
        if not done:
            return None
        return int(done[-1].name.split("_")[1])

    def restore(self, step: int, like: Any) -> Any:
        d = self.dir / f"step_{step:08d}"
        if not (d / "INDEX.json").exists():
            raise FileNotFoundError(f"incomplete checkpoint {d}")
        with np.load(d / f"shard_{self.shard_id}.npz") as npz:
            flat = dict(npz)
        return _unflatten_into(like, flat)

    def restore_aux(self, step: int) -> Any:
        """The JSON sidecar saved with ``step`` (None if there is
        none)."""
        d = self.dir / f"step_{step:08d}"
        if not (d / "INDEX.json").exists():
            raise FileNotFoundError(f"incomplete checkpoint {d}")
        p = d / "aux.json"
        return json.loads(p.read_text()) if p.exists() else None
