"""Fault-tolerant training driver: checkpoint/restart, failure retry,
straggler monitoring.

The port of `repro/runtime/fault_tolerance.py`.  The driver owns the
loop; the step function is functional (it returns a new state and
leaves the given one unchanged), so recovery is always "restore the
state, replay the data stream from step k": the deterministic pipeline
and the checkpoints are all it needs.  Failure injection is a
constructor hook so tests can fail arbitrary steps.  A step ends when
its loss is read to the host, which waits for the device; `device` is
where a restore places the state (the reference's `state_shardings`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer, latest_step,
                                               restore)


@dataclasses.dataclass
class StragglerStats:
    ema: float = 0.0
    count: int = 0
    slow_steps: list = dataclasses.field(default_factory=list)
    threshold: float = 3.0

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        if self.count == 0:
            self.ema = dt
        slow = self.count > 2 and dt > self.threshold * self.ema
        self.ema = 0.9 * self.ema + 0.1 * dt
        self.count += 1
        if slow:
            self.slow_steps.append((step, dt, self.ema))
        return slow


class TrainDriver:
    def __init__(self, *, step_fn: Callable, state, pipeline, ckpt_dir: str,
                 ckpt_every: int = 50, max_retries: int = 3,
                 fail_hook: Optional[Callable[[int], None]] = None,
                 device=None):
        self.step_fn = step_fn
        self.state = state
        self.pipeline = pipeline
        self.ckpt = AsyncCheckpointer(ckpt_dir)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.fail_hook = fail_hook
        self.device = device
        self.straggler = StragglerStats()
        self.metrics_log: list[dict] = []
        self.recoveries = 0

    def _restore_latest(self, default_step: int) -> int:
        step = latest_step(self.ckpt_dir)
        if step is None:
            return default_step
        self.state = restore(self.ckpt_dir, step, self.state,
                             device=self.device)
        return step

    def run(self, n_steps: int, start_step: int = 0) -> Any:
        step = self._restore_latest(start_step)
        while step < n_steps:
            batch = self.pipeline.batch_at(step)
            t0 = time.perf_counter()
            try:
                if self.fail_hook is not None:
                    self.fail_hook(step)      # may raise (simulated failure)
                self.state, metrics = self.step_fn(self.state, batch)
                loss = float(metrics["loss"])     # waits for the device
            except Exception:
                # node failure: restore last checkpoint and replay
                self.recoveries += 1
                if self.recoveries > self.max_retries:
                    raise
                self.ckpt.wait()
                step = self._restore_latest(start_step)
                continue
            dt = time.perf_counter() - t0
            self.straggler.observe(step, dt)
            self.metrics_log.append({"step": step, "loss": loss, "dt": dt})
            step += 1
            if step % self.ckpt_every == 0:
                self.ckpt.save(step, self.state)
        self.ckpt.wait()
        return self.state
