"""Fault tolerance: host-side and mesh-agnostic.

Port of ``repro/distributed/fault_tolerance.py``:

  * HeartbeatMonitor — per-worker liveness with a configurable timeout;
    the heartbeat clock is injectable for tests.
  * retry_step — bounded retry of a step function on transient failure
    (preemption, a flaky interconnect); deterministic because the data
    batch and RNG are replayed by step index.
  * ElasticPlan — when a mesh slice is lost, plan the new mesh shape and
    the data-skip from the latest checkpoint.
  * BoundedStalenessBarrier — up to ``max_stale`` stragglers may miss a
    sync barrier by up to ``max_lag`` steps before the step blocks (the
    cluster driver's ``max_stale``/``max_lag``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence


class WorkerFailure(RuntimeError):
    pass


@dataclasses.dataclass
class HeartbeatMonitor:
    n_workers: int
    timeout_s: float = 30.0
    last_beat: dict = dataclasses.field(default_factory=dict)
    clock: Callable[[], float] = time.monotonic

    def beat(self, worker: int, at: float | None = None) -> None:
        self.last_beat[worker] = self.clock() if at is None else at

    def dead_workers(self) -> list[int]:
        now = self.clock()
        return [
            w for w in range(self.n_workers)
            if now - self.last_beat.get(w, -1e18) > self.timeout_s
        ]

    def healthy(self) -> bool:
        return not self.dead_workers()


def retry_step(
    step_fn: Callable[[], object],
    max_retries: int = 3,
    backoff_s: float = 0.0,
    retriable: tuple = (WorkerFailure,),
    on_retry: Callable[[int, Exception], None] | None = None,
):
    """Run ``step_fn`` with bounded retries on transient failures."""
    attempt = 0
    while True:
        try:
            return step_fn()
        except retriable as exc:  # noqa: PERF203
            attempt += 1
            if attempt > max_retries:
                raise
            if on_retry:
                on_retry(attempt, exc)
            if backoff_s:
                time.sleep(backoff_s * attempt)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Recovery plan after losing mesh slices."""

    old_shape: tuple
    new_shape: tuple
    axis_names: tuple
    restore_step: int
    data_skip_batches: int


def plan_elastic_restart(
    old_shape: Sequence[int],
    axis_names: Sequence[str],
    lost_axis: str,
    lost_count: int,
    checkpoint_step: int,
    failed_step: int,
    global_batch: int,
) -> ElasticPlan:
    """Shrink ``lost_axis`` by ``lost_count`` (e.g. pod 2 -> 1) and compute
    the deterministic data-skip so no example is dropped or repeated."""
    idx = list(axis_names).index(lost_axis)
    new_shape = list(old_shape)
    new_shape[idx] -= lost_count
    if new_shape[idx] < 1:
        raise ValueError("cannot lose every slice of an axis")
    return ElasticPlan(
        old_shape=tuple(old_shape),
        new_shape=tuple(new_shape),
        axis_names=tuple(axis_names),
        restore_step=checkpoint_step,
        data_skip_batches=(failed_step - checkpoint_step),
    )


@dataclasses.dataclass
class BoundedStalenessBarrier:
    """Straggler-tolerant sync: a step may proceed while <= max_stale
    workers lag by <= max_lag steps; beyond that it blocks (backup-worker
    data-parallel sync)."""

    n_workers: int
    max_stale: int = 1
    max_lag: int = 1
    progress: dict = dataclasses.field(default_factory=dict)

    def report(self, worker: int, step: int) -> None:
        self.progress[worker] = step

    def can_proceed(self, step: int) -> bool:
        lagging = [
            w for w in range(self.n_workers)
            if step - self.progress.get(w, 0) > self.max_lag
        ]
        return len(lagging) <= self.max_stale
