"""Threaded cache-builder: the Stage-2 half of the paper's pipeline.

Port of ``repro/pipeline/cache_builder.py``. The paper (Section V-A)
claims "an asynchronous double-buffered pipeline makes adaptation
effectively free": a builder thread plans the next window's hot set and
bulk-fetches the missing rows while the trainer keeps consuming the
immutable *active* buffer; the swap at the window boundary is an O(1)
pointer flip. ``plan_window`` and the bulk feature gather run off the
consumer thread, wall times are measured (``time.perf_counter``), and the
consumer only blocks for whatever part of the build was not hidden.

On the card the builder also assembles the next window's device payload
table (``build_table``, the device tier's ``build`` on a CUDA stream of
its own), so the swap is a stream wait and a pointer flip.

Concurrency contract (single producer, single consumer):
  * exactly one consumer thread calls ``submit`` / ``wait`` / ``swap``;
  * builds are serialized inside the builder thread in submit order;
  * the consumer must not ``swap`` while a build it submitted afterwards is
    in flight (plans diff against ``cache.active_nodes``; the generation tag
    on the published buffer lets ``swap`` detect violations).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np

from repro_torch.analysis import runtime as _sanitizer
from repro_torch.core.windowed_cache import DoubleBufferedCache, RebuildPlan
from repro_torch.obs.tracer import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class PendingBuffer:
    """Immutable published result of one background rebuild."""

    plan: RebuildPlan
    features: np.ndarray      # rows for plan.hot_nodes[plan.fetched]
    generation: int           # cache generation the plan was diffed against
    t_plan_s: float           # measured planning wall time
    t_fetch_s: float          # measured bulk-gather wall time
    t_total_s: float          # submit -> publish wall time
    net: object | None = None  # net.TransferResult when the builder issues
                               # its bulk fetch through a Fabric
    table: object | None = None  # build_table's result (the device tier's
                                 # PendingTable), None without one


class BuildTicket:
    """Handle for one in-flight build; resolved by the builder thread."""

    def __init__(self, ticket_id: int):
        self.id = ticket_id
        self.done = threading.Event()
        self.result: PendingBuffer | None = None
        self.error: BaseException | None = None
        self.t_submit = time.perf_counter()


class CacheBuilder:
    """Background thread running plan + bulk fetch for a DoubleBufferedCache.

    ``fetch_fn(node_ids) -> np.ndarray`` performs the bulk feature gather
    for the rows that must be fetched remotely (a feature-store row
    gather), a real memcpy whose wall time is measured.

    With ``fabric`` set (a ``net.Fabric``), the builder also issues the
    rebuild's per-owner bulk transfer through ``Fabric.transfer()``, the
    call the consumer uses for per-step miss fetches, attributed to
    ``requester`` and stamped with the consumer's virtual clock
    (``clock_fn()``), so background rebuilds contend with foreground
    traffic on the modeled links; the result is published on the buffer
    (``PendingBuffer.net``). ``Fabric.transfer`` is thread-safe.

    ``build_table(plan, features)``, when given, runs last on the builder
    thread and its result is published as ``PendingBuffer.table``.
    """

    def __init__(
        self,
        cache: DoubleBufferedCache,
        fetch_fn,
        fabric=None,
        bytes_per_row: float = 0.0,
        requester: int = 0,
        clock_fn=None,
        sanitize: bool | None = None,
        tracer=NULL_TRACER,
        build_table=None,
    ):
        self.cache = cache
        self.fetch_fn = fetch_fn
        self.fabric = fabric
        self.bytes_per_row = float(bytes_per_row)
        self.requester = int(requester)
        self.clock_fn = clock_fn
        self.build_table = build_table
        # greentrace: pipeline spans (plan/fetch/exposed-wait/swap) are
        # anchored at the worker's virtual clock with MEASURED durations:
        # the threaded pipeline is the measured lane, so these spans carry
        # wall observations, not modeled time
        self.tracer = tracer
        self._work: queue.Queue = queue.Queue()
        self._next_id = 0
        self._thread: threading.Thread | None = None
        # sanitizer: all consumer-side calls must stay on one thread
        self._affinity = (
            _sanitizer.ThreadAffinity("CacheBuilder consumer")
            if _sanitizer.sanitize_enabled(sanitize) else None
        )
        # measured aggregates (written by the consumer thread in wait())
        self.n_builds = 0
        self.builder_wall_s = 0.0
        self.exposed_wait_s = 0.0
        self.swap_latency_s: list[float] = []

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "CacheBuilder":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, name="cache-builder", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._work.put(None)
            self._thread.join(timeout=10.0)
        self._thread = None

    def __enter__(self) -> "CacheBuilder":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- interface
    def submit(
        self, window_batches: list[np.ndarray], weights: np.ndarray
    ) -> BuildTicket:
        """Enqueue a rebuild; returns immediately with a ticket."""
        if self._affinity is not None:
            self._affinity.check("CacheBuilder.submit")
        self._next_id += 1
        ticket = BuildTicket(self._next_id)
        self._work.put((ticket, window_batches, np.asarray(weights).copy()))
        return ticket

    def wait(self, ticket: BuildTicket) -> tuple[PendingBuffer, float]:
        """Block until the build is published; returns (buffer, exposed_s).

        ``exposed_s`` is the time THIS call blocked: the part of the
        rebuild the pipeline failed to hide behind consumer compute. A
        build that raised raises here, on the consumer thread."""
        if self._affinity is not None:
            self._affinity.check("CacheBuilder.wait")
        t0 = time.perf_counter()
        ticket.done.wait()
        exposed = time.perf_counter() - t0
        if ticket.error is not None:
            raise ticket.error
        buf = ticket.result
        self.n_builds += 1
        self.builder_wall_s += buf.t_total_s
        self.exposed_wait_s += exposed
        if self.tracer.enabled:
            t = self._vclock()
            self.tracer.span(
                "pipeline", "exposed-wait", t, t + exposed,
                args={"exposed_s": float(exposed),
                      "hidden_s": float(max(buf.t_total_s - exposed, 0.0)),
                      "plan_s": float(buf.t_plan_s),
                      "build_fetch_s": float(buf.t_fetch_s),
                      "ticket": int(ticket.id)},
            )
        return buf, exposed

    def swap(self, buf: PendingBuffer) -> float:
        """Atomically promote a published buffer; returns swap latency (s).

        Raises if the buffer was planned against a different generation
        than the one currently active (its persisted/fetched diff would be
        stale)."""
        if self._affinity is not None:
            self._affinity.check("CacheBuilder.swap")
        if buf.generation != self.cache.generation:
            raise RuntimeError(
                f"stale pending buffer: built against generation "
                f"{buf.generation}, cache is at {self.cache.generation}"
            )
        t0 = time.perf_counter()
        self.cache.swap(buf.plan)
        dt = time.perf_counter() - t0
        self.swap_latency_s.append(dt)
        if self.tracer.enabled:
            t = self._vclock()
            self.tracer.span(
                "pipeline", "swap", t, t + dt,
                args={"swap_s": float(dt),
                      "generation": int(buf.generation)},
            )
        return dt

    def build_sync(
        self, window_batches: list[np.ndarray], weights: np.ndarray
    ) -> tuple[PendingBuffer, float]:
        """Cold-start path: submit and block (fully exposed rebuild)."""
        return self.wait(self.submit(window_batches, weights))

    # ------------------------------------------------------------- internals
    def _vclock(self) -> float:
        """The owning worker's virtual time (0.0 without a clock_fn)."""
        return float(self.clock_fn().t_s) if self.clock_fn is not None else 0.0

    def _loop(self) -> None:
        while True:
            item = self._work.get()
            if item is None:
                return
            ticket, window_batches, weights = item
            try:
                ticket.result = self._build(ticket, window_batches, weights)
            # greenlint: broad-except — thread boundary: the ticket ferries
            # the exception to the consumer, which re-raises it in wait()
            except BaseException as e:
                ticket.error = e
            finally:
                ticket.done.set()

    def _build(
        self, ticket: BuildTicket, window_batches, weights
    ) -> PendingBuffer:
        t0 = time.perf_counter()
        generation = self.cache.generation
        plan = self.cache.plan_window(window_batches, weights)
        t1 = time.perf_counter()
        fetch_ids = plan.hot_nodes[plan.fetched]
        features = self.fetch_fn(fetch_ids)
        t2 = time.perf_counter()
        net = None
        if self.fabric is not None:
            net = self.fabric.transfer(
                plan.per_owner_fetched.astype(np.float64), self.bytes_per_row,
                requester=self.requester,
                clock=self.clock_fn() if self.clock_fn is not None else None,
            )
        if self.tracer.enabled:
            # builder-thread spans: anchored at the virtual clock, measured
            # durations laid back to back (plan, then gather)
            t = self._vclock()
            self.tracer.span(
                "pipeline", "plan", t, t + (t1 - t0),
                args={"plan_s": float(t1 - t0), "ticket": int(ticket.id),
                      "n_fetch": int(plan.fetched.sum())},
            )
            self.tracer.span(
                "pipeline", "fetch", t + (t1 - t0), t + (t2 - t0),
                args={"fetch_s": float(t2 - t1), "ticket": int(ticket.id),
                      "rows": float(plan.per_owner_fetched.sum())},
            )
        table = None
        if self.build_table is not None:
            table = self.build_table(plan, features)
        return PendingBuffer(
            plan=plan,
            features=features,
            generation=generation,
            t_plan_s=t1 - t0,
            t_fetch_s=t2 - t1,
            t_total_s=time.perf_counter() - ticket.t_submit,
            net=net,
            table=table,
        )
