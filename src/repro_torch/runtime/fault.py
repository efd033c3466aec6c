"""Fault tolerance: checkpoint/restart loop, failure injection,
straggler detection.

Counterpart of the JAX package's ``runtime/fault.py``.  The train step
is a function of (state, batch) and the data stream a function of the
step index (``data/pipeline.py``), so recovery is "restore the last
complete checkpoint, rewind the stream to that step, continue".

  * :class:`StepWatchdog` — median-based straggler detection plus an
    optional hard per-step timeout; shared by the training loop and
    the serving engine (``serving/engine.py``).
  * :class:`FaultTolerantLoop` — wraps a step function with periodic
    (async) checkpoints, failure capture, bounded restarts and the
    step-time watchdog.
  * :class:`FailureInjector` — deterministic fault schedule for tests
    (raise at step k / slow a step by t).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from ..checkpoint.ckpt import Checkpointer


class FailureInjector:
    def __init__(self, fail_at: Optional[Dict[int, Exception]] = None,
                 slow_at: Optional[Dict[int, float]] = None):
        self.fail_at = dict(fail_at or {})
        self.slow_at = dict(slow_at or {})

    def before_step(self, step: int) -> None:
        if step in self.slow_at:
            time.sleep(self.slow_at.pop(step))
        if step in self.fail_at:
            raise self.fail_at.pop(step)


@dataclasses.dataclass
class LoopStats:
    restarts: int = 0
    straggler_steps: int = 0
    completed_steps: int = 0
    step_times: List[float] = dataclasses.field(default_factory=list)


class StepWatchdog:
    """Step-time anomaly classifier: stragglers and hard timeouts.

    ``observe(step, dt)`` returns ``None`` for a normal step,
    ``"straggler"`` when ``dt`` exceeds ``straggler_factor`` times the
    rolling median of the last ``window`` steps (needing at least
    ``min_samples`` observations — cold-start compilations must not
    count), or ``"timeout"`` when ``dt`` exceeds the absolute
    ``timeout_s`` budget (0 disables).  A timeout outranks a straggler:
    it is the caller's signal to fail the step, not merely to note it.
    """

    def __init__(self, straggler_factor: float = 3.0, timeout_s: float = 0.0,
                 window: int = 64, min_samples: int = 8,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.straggler_factor = straggler_factor
        self.timeout_s = timeout_s
        self.window = window
        self.min_samples = min_samples
        self.on_straggler = on_straggler
        self.step_times: List[float] = []
        self.straggler_steps = 0
        self.timeout_steps = 0

    def observe(self, step: int, dt: float) -> Optional[str]:
        times = self.step_times
        times.append(dt)
        verdict = None
        if len(times) >= self.min_samples:
            tail = times[-self.window:]
            med = sorted(tail)[len(tail) // 2]
            if dt > self.straggler_factor * med:
                self.straggler_steps += 1
                if self.on_straggler:
                    self.on_straggler(step, dt)
                verdict = "straggler"
        if self.timeout_s > 0 and dt > self.timeout_s:
            self.timeout_steps += 1
            verdict = "timeout"
        if len(times) > 4 * self.window:
            del times[:2 * self.window]
        return verdict


class FaultTolerantLoop:
    """Runs ``step_fn(state, batch_fn(step))`` for steps 0..n-1 from the
    latest complete checkpoint, saving every ``save_every`` steps and
    at the last; any exception restores the latest checkpoint (or
    restarts from step 0 and the given state) up to ``max_restarts``
    times.  Every exception counts as a restart, so a caller that must
    not fail checks ``stats.restarts``."""

    def __init__(
        self,
        step_fn: Callable[[Any, Any], Any],      # (state, batch) -> state
        batch_fn: Callable[[int], Any],          # step -> batch
        ckpt: Checkpointer,
        save_every: int = 50,
        max_restarts: int = 5,
        straggler_factor: float = 3.0,
        injector: Optional[FailureInjector] = None,
        on_straggler: Optional[Callable[[int, float], None]] = None,
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt = ckpt
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.straggler_factor = straggler_factor
        self.injector = injector
        self.on_straggler = on_straggler
        self.stats = LoopStats()
        self.watchdog = StepWatchdog(straggler_factor=straggler_factor,
                                     on_straggler=on_straggler)
        # LoopStats.step_times is the watchdog's rolling buffer
        self.stats.step_times = self.watchdog.step_times

    def run(self, state: Any, n_steps: int) -> Any:
        start = self.ckpt.latest_step()
        step = 0
        if start is not None:
            state = self.ckpt.restore(start, state)
            step = start + 1
        restarts = 0
        while step < n_steps:
            try:
                t0 = time.time()
                if self.injector:
                    self.injector.before_step(step)
                batch = self.batch_fn(step)
                state = self.step_fn(state, batch)
                dt = time.time() - t0
                self._watchdog(step, dt)
                self.stats.completed_steps += 1
                if step % self.save_every == 0 or step == n_steps - 1:
                    self.ckpt.save(step, state, async_=True)
                step += 1
            except Exception:
                restarts += 1
                self.stats.restarts += 1
                if restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                last = self.ckpt.latest_step()
                if last is not None:
                    state = self.ckpt.restore(last, state)
                    step = last + 1
                else:
                    step = 0
        self.ckpt.wait()
        return state

    def _watchdog(self, step: int, dt: float) -> None:
        if self.watchdog.observe(step, dt) == "straggler":
            self.stats.straggler_steps += 1
