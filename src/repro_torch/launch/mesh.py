"""The serving allocation plane across processes: one rank per DP shard.

Counterpart of the JAX package's ``launch/mesh.py``.  The reference
builds a one-axis ``("dp",)`` device mesh and shard_maps its serving
steps over it, so each device holds exactly one DP shard's pool, lanes,
refcounts, pin rows, expert pages and KV pages.  The port runs one
process (a *rank*) per DP shard under ``torch.distributed``: each rank
keeps its shard's device state as ``[1, Bl, ...]`` (``[L, 1, ...]``)
tensors on its own device, every rank runs the same host control
(admission, prefix trie, pin and expert ledgers) on the same submitted
requests, and the ranks meet in one collective a serve step, the
all-gather of the packed status (:meth:`DPGroup.gather_status`), plus
the share steps' one-flag verdict (:meth:`DPGroup.agree`).

The backend is always the caller's: ``nccl`` with one rank per card, or
``gloo`` for CPU ranks and for ranks that share a card (NCCL refuses two
ranks on one card).

  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --dp 2 \\
      --mesh auto --dist-backend nccl

The dry run's meshes (:func:`make_production_mesh`,
:func:`make_smoke_mesh`) are the reference's production and smoke
meshes seen from rank 0: a ``DeviceMesh`` over a fake process group
(``torch.testing._internal.distributed.fake_pg``), whose collectives
run nowhere.  A trace over it holds rank 0's local shards and the
collectives DTensor inserts (``launch/roofline.py`` counts them).

Nothing here touches ``torch.distributed`` or a device at import.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

#: The serving allocation plane's axis name: one rank per DP shard.
SERVE_DP_AXIS = "dp"

#: The process-group backends a DP group may run on.
BACKENDS = ("nccl", "gloo")


def _checked(backend: str, device) -> torch.device:
    """``device`` as a ``torch.device``, once ``backend`` is known and
    runs there: nccl on cards only."""
    if backend not in BACKENDS:
        raise ValueError(f"DP group backend {backend!r}: one of {BACKENDS}")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an nccl DP group runs on cards: one rank per "
                         "card; use gloo for CPU ranks")
    return device


@dataclasses.dataclass
class DPGroup:
    """The ranks of one serving allocation plane, the default process
    group of ``torch.distributed``: ``size`` == dp, rank ``r`` owns DP
    shard ``r`` on ``device``."""
    rank: int
    size: int
    device: torch.device
    backend: str

    def __post_init__(self):
        self.device = _checked(self.backend, self.device)

    @property
    def coll_device(self) -> torch.device:
        """Where the collectives run: the rank's card under nccl, the
        host under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def gather(self, local: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Concatenation along the DP ``axis`` of every rank's ``local``
        (the same shape on every rank, any dtype), in rank order, on
        :attr:`coll_device`.  The bytes travel, so bool and bfloat16
        leaves gather as they are.  Every rank must call it at the same
        point."""
        x = local.to(self.coll_device).contiguous()
        flat = x.reshape(-1).view(torch.uint8)
        parts = [torch.empty_like(flat) for _ in range(self.size)]
        dist.all_gather(parts, flat)
        return torch.cat([p.view(x.dtype).reshape(x.shape) for p in parts],
                         axis)

    def gather_status(self, local: torch.Tensor) -> np.ndarray:
        """The serve step's one collective and one device->host copy:
        the reference's ``all_gather(status, "dp", axis=1, tiled=True)``
        of the packed ``[R, 1, Bl]`` status into ``[R, DP, Bl]`` on the
        host, rank order == shard order.  Under nccl the gather runs on
        the cards and the gathered status is copied down; under gloo the
        rank copies its own status down and the host copies are
        gathered."""
        if self.backend == "nccl":
            return self.gather(local, 1).cpu().numpy()
        return self.gather(local.cpu(), 1).numpy()

    def agree(self, flag) -> bool:
        """True iff ``flag`` (a bool or a 0-d tensor) is true on some
        rank: the share steps' verdict, which only the owning rank of the
        destination slot computes (the reference's ``psum`` of the dst
        shard's ``ok``).  One all-reduce and one host read."""
        t = torch.as_tensor(flag).to(self.coll_device, torch.int32).reshape(1)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())


def make_dp_group(dp: int, backend: str, device,
                  init_method: Optional[str] = None,
                  timeout_s: float = 300.0) -> DPGroup:
    """Join (or start) the process group of a ``dp``-rank serving plane.

    An initialised default group is joined as it is (its backend must be
    ``backend``); otherwise it is initialised from ``init_method``, or
    from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``).  The world size must equal ``dp``.

    ``device``: ``"cpu"`` or a card.  Under nccl each rank takes its own
    card, ``cuda:LOCAL_RANK`` when no index is given, and two ranks on
    one card raise; under gloo ``"cuda"`` is the current card, which the
    ranks then share.
    """
    device = _checked(backend, device)
    if backend == "nccl":
        if torch.cuda.device_count() < dp:
            raise RuntimeError(
                f"make_dp_group: nccl with {dp} ranks needs {dp} cards, "
                f"this host shows {torch.cuda.device_count()}: NCCL refuses "
                f"two ranks on one card; use gloo for ranks that share one")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", os.environ.get("RANK", "0"))))
    elif device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if init_method is None and "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "make_dp_group: no process group and no torchrun "
                "environment (RANK, WORLD_SIZE); launch the ranks with "
                "torchrun or pass init_method")
        kw = {}
        if init_method is not None:
            kw = dict(rank=int(os.environ["RANK"]),
                      world_size=int(os.environ["WORLD_SIZE"]))
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    elif dist.get_backend() != backend:
        raise ValueError(f"make_dp_group: the process group runs "
                         f"{dist.get_backend()}, not {backend}")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != dp:
        raise ValueError(f"make_dp_group: {world} ranks for dp={dp}: one "
                         f"rank per DP shard")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    group = DPGroup(rank=rank, size=world, device=device, backend=backend)
    if backend == "nccl":
        idx = group.gather(torch.tensor([device.index], device=device))
        if len(set(idx.tolist())) != world:
            raise RuntimeError(f"make_dp_group: nccl ranks share cards "
                               f"{idx.tolist()}: one rank per card")
    return group


@contextlib.contextmanager
def fake_mesh(shape: Sequence[int], names: Sequence[str]) -> Iterator:
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over a fake
    process group of ``prod(shape)`` ranks, this process rank 0, on
    host tensors; the group is destroyed on exit.

    Raises if a default group already exists: joining one would make
    the fake ranks real ones, and a fake group left behind would be
    joined by the next :func:`make_dp_group`."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            "fake_mesh: a process group is already initialised "
            f"({dist.get_backend()}, {dist.get_world_size()} ranks); the "
            "dry run's mesh needs a process of its own")
    n = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield DeviceMesh("cpu", torch.arange(n).reshape(tuple(shape)),
                         mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh, rank 0's view, as a context
    manager: 16 x 16 = 256 devices ("data", "model"), or 2 x 16 x 16 =
    512 ("pod", "data", "model") multi-pod."""
    if multi_pod:
        return fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return fake_mesh((16, 16), ("data", "model"))


def make_smoke_mesh():
    """A 1 x 1 mesh with the production axis names (a context manager)."""
    return fake_mesh((1, 1), ("data", "model"))


def nearest_mesh_for(n_devices: int, model_parallel: int = 16):
    """Elastic fallback: best (data, model) factorization for a device set.

    Used by runtime/elastic.py when membership changes: keep the model
    axis if divisible, shrink data parallelism to what remains.
    """
    while model_parallel > 1 and n_devices % model_parallel:
        model_parallel //= 2
    data = n_devices // model_parallel
    return (data, model_parallel), ("data", "model")
