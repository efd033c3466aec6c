"""Step-time anomaly classification for the serving engine.

Only :class:`StepWatchdog` is carried over from the JAX package's
``runtime/fault.py``: the checkpoint/restart loop and its failure
injector wait for the fault-tolerance slice of the port.
"""

from __future__ import annotations

from typing import Callable, List, Optional


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
