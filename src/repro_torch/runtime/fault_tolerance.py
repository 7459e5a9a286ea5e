"""Fault tolerance + elasticity for 1000+-node operation.

The port's own copy of `repro.runtime.fault_tolerance` (pure Python,
unchanged but for this note); `TrainSupervisor` drives the port's
`CheckpointManager` (or any object with its `latest_step`, `save`,
`restore` and `wait`).

Components:
  StragglerDetector — per-step EWMA of step time; flags hosts whose step
      latency exceeds mean + k·σ (at pod scale the right reaction is to
      drop the host from the next elastic re-mesh, not to block).
  ElasticMesh — recompute (pod, data, model) mesh shape when the healthy
      device count changes; model-parallel degree is pinned (weights are
      sharded over it), the data axes absorb the change, and global batch
      is re-divided — callers re-lower the step on the new mesh and
      restore from the latest checkpoint.
  TrainSupervisor — crash-isolation loop: run_step is retried through
      checkpoint restore on failure, with simulated-failure hooks for
      tests (this is the unit under test on CPU; on a real pod the same
      logic runs per-host around the distributed runtime).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

__all__ = ["StragglerDetector", "ElasticMesh", "TrainSupervisor"]


class StragglerDetector:
    """EWMA step-time tracker with z-score flagging."""

    def __init__(self, alpha: float = 0.1, threshold_sigma: float = 3.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.k = threshold_sigma
        self.warmup = warmup
        self.mean: float | None = None
        self.var = 0.0
        self.n = 0
        self.flagged: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.n += 1
        if self.mean is None:
            self.mean = dt
            return False
        is_straggler = False
        if self.n > self.warmup:
            sigma = math.sqrt(self.var) if self.var > 0 else self.mean * 0.1
            if dt > self.mean + self.k * sigma:
                is_straggler = True
                self.flagged.append(step)
        # EWMA update (straggler samples still update, damped)
        a = self.alpha * (0.25 if is_straggler else 1.0)
        delta = dt - self.mean
        self.mean += a * delta
        self.var = (1 - a) * (self.var + a * delta * delta)
        return is_straggler


@dataclasses.dataclass
class ElasticMesh:
    """Recompute mesh shape as devices come and go."""

    model_parallel: int = 16       # pinned: weights are sharded over it
    min_data: int = 1

    def plan(self, n_devices: int) -> dict:
        """Largest (pod, data, model) grid usable with n_devices."""
        if n_devices < self.model_parallel * self.min_data:
            raise RuntimeError(
                f"{n_devices} devices cannot host model_parallel="
                f"{self.model_parallel}")
        usable_rows = n_devices // self.model_parallel
        # prefer 2 pods when enough rows survive, else single pod
        if usable_rows >= 32:
            pods, data = 2, usable_rows // 2
        else:
            pods, data = 1, usable_rows
        used = pods * data * self.model_parallel
        return {"pod": pods, "data": data, "model": self.model_parallel,
                "devices_used": used, "devices_idle": n_devices - used}

    def rebatch(self, global_batch: int, old_data: int, new_data: int
                ) -> int:
        """Keep per-shard batch constant; global batch scales with the
        surviving data parallelism (elastic batch scaling)."""
        per_shard = max(1, global_batch // old_data)
        return per_shard * new_data


class TrainSupervisor:
    """Checkpoint/restart supervision around a step function."""

    def __init__(self, ckpt_manager, save_every: int = 50,
                 max_restarts: int = 10, save_blocking: bool = True):
        self.ckpt = ckpt_manager
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.save_blocking = save_blocking
        self.restarts = 0
        self.straggler = StragglerDetector()

    def run(self, state, run_step: Callable, n_steps: int,
            fail_hook: Callable | None = None,
            meta: dict | None = None):
        """Run n_steps with checkpoint/restart.  `run_step(state, step)
        -> state`.  `fail_hook(step)` may raise to simulate failures."""
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            state, m = self.ckpt.restore(state)
            start = m["step"]
        step = start
        while step < n_steps:
            try:
                if fail_hook is not None:
                    fail_hook(step)
                t0 = time.time()
                state = run_step(state, step)
                self.straggler.observe(step, time.time() - t0)
                step += 1
                if step % self.save_every == 0 or step == n_steps:
                    # with save_blocking=False a failed async write
                    # surfaces at the NEXT save's wait() — still inside
                    # this try, so it takes the restart path below
                    self.ckpt.save(step, state, meta or {},
                                   blocking=self.save_blocking)
                    if step == n_steps:
                        self.ckpt.wait()
            except Exception:  # noqa: BLE001 — restart from checkpoint
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                latest = self.ckpt.latest_step()
                if latest is None:
                    step = 0
                    continue
                state, m = self.ckpt.restore(state)
                step = m["step"]
        return state, step
