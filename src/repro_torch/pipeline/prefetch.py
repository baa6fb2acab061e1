"""Bounded Stage-3 prefetch queue (paper Section V-A).

Port of ``repro/pipeline/prefetch.py``. A resolver thread pulls upcoming batches off a schedule and materializes
their feature payloads up to ``depth`` (= the paper's Q) batches ahead of
the consumer. The results queue is bounded, so the resolver can never run
more than Q batches ahead — exactly the "async queue of depth Q" the
analytic model charged ``Q * t_base`` of slack for; here the lead and any
consumer-side wait are *measured*.

Accounting stays in the consumer: the prefetcher only performs the payload
gather (a real memcpy). Hit/miss classification against the double-buffered
cache is done synchronously by the consumer against the *current* active
buffer, so prefetch timing can never perturb the hit/miss stream — this is
what makes threaded-vs-synchronous parity exact.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time

from repro_torch.analysis import runtime as _sanitizer

# a get() blocking longer than this counts as a prefetch stall event
STALL_EPS_S = 1e-3


@dataclasses.dataclass(frozen=True)
class PrefetchItem:
    index: int              # position in the schedule
    payload: object         # resolved result (e.g. gathered feature rows)
    t_resolved: float       # perf_counter when the resolver finished
    t_resolve_s: float      # wall time of the resolve itself


class PrefetchQueue:
    """Single-producer resolver thread + bounded FIFO of resolved batches.

    ``resolve_fn(item) -> payload`` runs on the resolver thread.
    The consumer calls ``get()`` and receives items strictly in schedule
    order together with its measured wait and the item's lead time.
    """

    def __init__(self, resolve_fn, depth: int, sanitize: bool | None = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.resolve_fn = resolve_fn
        self.depth = int(depth)
        # sanitizer: all consumer-side calls must stay on one thread
        self._affinity = (
            _sanitizer.ThreadAffinity("PrefetchQueue consumer")
            if _sanitizer.sanitize_enabled(sanitize) else None
        )
        self._out: queue.Queue = queue.Queue(maxsize=self.depth)
        self._schedule: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._next_get = 0
        self._n_scheduled = 0
        # measured aggregates
        self.n_got = 0
        self.wait_s = 0.0           # total consumer block time in get()
        self.lead_s = 0.0           # total (get time - resolve-done time)
        self.resolve_s = 0.0        # total resolver work time
        self.max_wait_s = 0.0       # worst single consumer block
        self.n_stalls = 0           # gets that blocked > STALL_EPS_S (the
                                    # "stalls reappear" events of Section II-B)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "PrefetchQueue":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="prefetcher", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._schedule.put(None)
            # drain so a blocked put() can observe the stop flag
            try:
                while True:
                    self._out.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=10.0)
        self._thread = None

    def __enter__(self) -> "PrefetchQueue":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- interface
    def schedule(self, items) -> None:
        """Append work items (resolved FIFO, at most ``depth`` ahead)."""
        if self._affinity is not None:
            self._affinity.check("PrefetchQueue.schedule")
        for item in items:
            self._schedule.put((self._n_scheduled, item))
            self._n_scheduled += 1

    def get(self) -> tuple[object, float, float]:
        """Next resolved batch in order -> (payload, wait_s, lead_s)."""
        if self._affinity is not None:
            self._affinity.check("PrefetchQueue.get")
        t0 = time.perf_counter()
        item: PrefetchItem = self._out.get()
        wait = time.perf_counter() - t0
        lead = max(0.0, t0 - item.t_resolved)
        if item.index != self._next_get:
            raise RuntimeError(
                f"out-of-order prefetch: got {item.index}, want "
                f"{self._next_get}"
            )
        self._next_get += 1
        self.n_got += 1
        self.wait_s += wait
        self.lead_s += lead
        self.resolve_s += item.t_resolve_s
        self.max_wait_s = max(self.max_wait_s, wait)
        if wait > STALL_EPS_S:
            self.n_stalls += 1
        return item.payload, wait, lead

    @property
    def mean_wait_s(self) -> float:
        return self.wait_s / max(self.n_got, 1)

    @property
    def mean_lead_s(self) -> float:
        return self.lead_s / max(self.n_got, 1)

    # ------------------------------------------------------------- internals
    def _loop(self) -> None:
        while not self._stop.is_set():
            work = self._schedule.get()
            if work is None:
                return
            idx, item = work
            t0 = time.perf_counter()
            payload = self.resolve_fn(item)
            t1 = time.perf_counter()
            out = PrefetchItem(idx, payload, t1, t1 - t0)
            # bounded: blocks when Q items are already resolved & unconsumed
            while not self._stop.is_set():
                try:
                    self._out.put(out, timeout=0.1)
                    break
                except queue.Full:
                    continue
