"""Data pipeline: deterministic sharded token streams.

The port's own copy of the JAX package's ``data/pipeline.py`` (numpy
only): ``TokenStream.batch_at`` gives the reference's arrays bit for
bit, so both packages train on the same batches.

Production shape: each host loads only its shard of the global batch
(``host_slice``), tokenizes/packs off the critical path, and double-
buffers ahead of the step loop.  For the reproduction the source is a
synthetic-but-deterministic token stream (seeded per shard and step), so
runs are reproducible across restarts and elastic re-sharding — the
stream is a pure function of (seed, step, position), not of worker
state, which is what makes checkpoint/restart and elastic scaling exact.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


class TokenStream:
    """Stateless synthetic LM stream: batch(step) is a pure function."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        out_tokens = np.empty((self.local_batch, cfg.seq_len + 1), np.int32)
        for i in range(self.local_batch):
            row = cfg.host_id * self.local_batch + i
            rng = np.random.Philox(key=cfg.seed + step * 1_000_003 + row)
            gen = np.random.Generator(rng)
            # Zipf-ish marginal like natural text; offset so 0 is padding
            toks = gen.zipf(1.3, size=cfg.seq_len + 1)
            out_tokens[i] = np.clip(toks, 1, cfg.vocab - 1)
        return {
            "tokens": out_tokens[:, :-1],
            "labels": out_tokens[:, 1:],
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """One-deep host-side prefetch (double buffering)."""

    def __init__(self, stream: TokenStream, start_step: int = 0):
        self.stream = stream
        self.step = start_step
        self._next = self.stream.batch_at(self.step)

    def get(self) -> Dict[str, np.ndarray]:
        cur = self._next
        self.step += 1
        self._next = self.stream.batch_at(self.step)
        return cur
