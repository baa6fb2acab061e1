"""Deterministic discrete-event congestion fabric (Stage-0 of the pipeline).

Port of ``repro/net/fabric.py`` (numpy float64, the same operations in the
same order, so transfers are bit-equal to the reference's). A traced
requester (``Fabric.set_tracer``) gets a greentrace span per transfer with
each owner link's queue, service and propagation times.

The trainer used to compute every remote fetch from the closed-form Eq. (4)
law ``alpha + beta*P + gamma_c*P*delta`` — no queueing, no bandwidth
contention, no shared bottleneck. This module replaces that with a small
event-driven network model operating on the trainer's *virtual* clock
(``EnergyMeter.wall_s``):

  * one serialization server per remote-owner link, with configurable
    capacity (bytes/s), one-way propagation delay (ms) and per-RPC
    initiation cost (s);
  * FIFO queueing per link: a transfer issued while the link is still
    draining an earlier one waits (``free_at`` bookkeeping) — this is how
    cache rebuilds contend with per-step miss fetches;
  * an optional shared bottleneck all owner responses must traverse
    (FIFO or processor-sharing), which produces incast collapse when
    several owners respond at once;
  * time-varying *injected delay* delta(t) [ms] and *background
    utilization* u(t) in [0, 1) per link, supplied by the scenario's
    delta/load processes (``net/background.py``).

Calibration identity: with zero delta, zero background load, no shared
bottleneck and the default link rate ``1/beta`` the fabric reproduces the
closed form exactly —

  wire service = P / (rate * (1-u) / (1 + (gamma_c/beta) * delta))
               = P * (beta + gamma_c * delta)   when u = 0, rate = 1/beta

so the `clean` scenario is bit-compatible with the trainer's closed forms
(``gnn_trainer._fetch_time`` / ``_chunked_fetch_time``).

Everything is driven by explicit virtual times and seeded processes: on
the synchronous trainer path two runs with the same seed produce
bit-identical transfer timings, hit/miss streams and energy totals.
``transfer`` and the telemetry accessors are guarded by a reentrant lock
so a builder thread may issue rebuild fetches through the same fabric
instance as the consumer thread (the threaded pipeline, not ported yet);
that interleaving is OS-scheduled, so such runs keep only identical
hit/miss streams, not bit-identical timings.

Requester-aware cluster mode (``n_parts`` set): instead of "one requester,
K owner links" the fabric models one NIC server per *partition*, shared by
every trainer. A transfer is issued by ``requester`` rank ``r`` against its
``n_parts - 1`` remote owners (requester-relative slot ``i`` maps to global
owner ``i`` skipping ``r``), and all requesters' transfers contend FIFO at
the same per-owner ``free_at`` bookkeeping — worker B's window rebuild
physically delays worker A's miss fetch to the same owner, and incast at a
hot owner emerges from real traffic instead of an injected load process.
Each requester keeps its own virtual clock (pass ``clock=``) and its own
shared-ingress bottleneck slot; per-requester byte/RPC/latency/queueing
tallies are exposed via :meth:`requester_metrics` so cluster reports can
attribute congestion to its source worker. Determinism contract: arrival
order at a NIC is the *call* order, so a cluster driver must serialize
transfers in a deterministic (virtual-time, rank) order; the fabric
itself never consults the OS clock.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch.analysis import runtime as _sanitizer
from repro_torch.core import cost_model as cm
from repro_torch.core.cost_model import CostModelParams


def owner_links(n_parts: int, requester: int) -> np.ndarray:
    """Requester-relative owner slots -> global partition NIC indices.

    Rank ``r`` of a ``n_parts``-partition cluster fetches from every
    partition but its own: slot ``i`` maps to global owner ``i`` skipping
    ``r``. This is THE owner-index mapping of the cluster topology — the
    fabric builds its per-requester link tables from it, and the training
    envs (``envs/cluster_sim.py``) use the same function so a policy's
    per-owner observation slots line up with the NICs it will see at
    deployment. Keeping it in one place prevents the silent
    ``n_owners == n_parts`` confusion (a requester sees ``n_parts - 1``
    owners, not ``n_parts``).
    """
    n_parts = int(n_parts)
    requester = int(requester)
    if not 0 <= requester < n_parts:
        raise ValueError(
            f"requester {requester} outside [0, n_parts={n_parts})"
        )
    return np.asarray(
        [p for p in range(n_parts) if p != requester], dtype=np.int64
    )


@dataclasses.dataclass(frozen=True)
class NetClock:
    """Virtual-time context a scenario's processes may condition on."""

    t_s: float = 0.0     # trainer's virtual wall clock (meter.wall_s)
    step: int = 0        # global training step
    epoch: int = 0


@dataclasses.dataclass(frozen=True)
class TransferResult:
    """Accounting record of one (multi-owner, possibly chunked) transfer."""

    raw_s: float               # wall latency of the slowest owner, incl.
                               # queueing + propagation (Eq. 3 straggler)
    cpu_s: float               # protocol CPU time summed over owners
                               # (initiation + delay-inflated payload work;
                               # excludes queue wait and propagation)
    nbytes: float
    n_rpcs: int
    per_owner_s: np.ndarray    # per-owner wall latency (0 where inactive)
    queue_s: float = 0.0       # total time spent waiting behind other
                               # traffic (the quantity the closed form
                               # cannot produce)

    def astuple(self) -> tuple[float, float, float, int]:
        """(raw, cpu, bytes, n_rpcs) — the legacy ``_fetch_time`` shape."""
        return self.raw_s, self.cpu_s, self.nbytes, self.n_rpcs


_ZERO = TransferResult(0.0, 0.0, 0.0, 0, np.zeros(0), 0.0)

# Background load is clamped so a saturated link degrades service 20x
# instead of dividing by zero. Single definition lives in the cost model,
# shared with both fluid twins.
MAX_UTILIZATION = cm.MAX_UTILIZATION


class Fabric:
    """Per-owner link servers + optional shared bottleneck, virtual-time.

    Parameters
    ----------
    params : CostModelParams — supplies alpha_rpc/beta/gamma_c defaults.
    n_owners : number of remote owners (one link each).
    delta_process / load_process : scenario processes (see
        ``net/background.py``); ``None`` means zero delay / idle links.
    shared_rate : bytes/s of the shared ingress bottleneck (``None`` = no
        shared hop). All owner responses serialize through it.
    shared_load_process : scalar background utilization of the shared hop.
    discipline : 'fifo' (arrival order) or 'ps' (processor sharing) for the
        shared bottleneck. Per-owner links are always FIFO.
    link_rate : per-link serialization rate(s) [bytes/s]; default 1/beta
        (the calibration identity). Scalar or per-link vector.
    prop_delay_ms : baseline one-way propagation per link (added to the
        injected delta in the RTT term).
    n_parts : cluster mode — one NIC server per partition (``n_parts``
        links, shared by all requesters); ``None`` keeps the legacy
        single-requester topology of ``n_owners`` links.
    n_requesters : number of trainer ranks issuing transfers (cluster
        mode); sizes the per-requester ingress slots and metric tallies.
    sanitize : arm the runtime sanitizer for this fabric (lock-held
        assertions on the transfer path); ``None`` defers to the
        ``REPRO_SANITIZE`` environment variable.
    """

    def __init__(
        self,
        params: CostModelParams,
        n_owners: int,
        delta_process=None,
        load_process=None,
        shared_rate: float | None = None,
        shared_load_process=None,
        discipline: str = "fifo",
        link_rate=None,
        prop_delay_ms=None,
        name: str = "fabric",
        n_parts: int | None = None,
        n_requesters: int = 1,
        sanitize: bool | None = None,
    ):
        if discipline not in ("fifo", "ps"):
            raise ValueError(f"unknown queueing discipline: {discipline!r}")
        self.params = params
        self.n_owners = int(n_owners)
        self.n_parts = int(n_parts) if n_parts is not None else None
        self.n_requesters = max(int(n_requesters), 1)
        if self.n_parts is not None:
            if self.n_owners != self.n_parts - 1:
                raise ValueError(
                    f"cluster fabric: n_owners ({self.n_owners}) must be "
                    f"n_parts - 1 ({self.n_parts - 1})"
                )
            if self.n_requesters > self.n_parts:
                raise ValueError(
                    f"{self.n_requesters} requesters > {self.n_parts} parts"
                )
            self.n_links = self.n_parts
            # requester rank r fetches from every partition but its own
            # (the shared owner-index mapping; see owner_links above)
            self._links_of = [
                owner_links(self.n_parts, r)
                for r in range(self.n_requesters)
            ]
        else:
            self.n_links = self.n_owners
            self._links_of = [np.arange(self.n_links)]
        self.delta_process = delta_process
        self.load_process = load_process
        self.shared_rate = float(shared_rate) if shared_rate else None
        self.shared_load_process = shared_load_process
        self.discipline = discipline
        self.name = name

        self.alpha = float(params.alpha_rpc)
        self.beta = float(params.beta)
        self.gamma_c = float(params.gamma_c)
        self.slope = self.gamma_c / self.beta  # sigma slope [1/ms]

        base_rate = 1.0 / self.beta
        self.link_rate = np.broadcast_to(
            np.asarray(
                base_rate if link_rate is None else link_rate, np.float64
            ),
            (self.n_links,),
        ).copy()
        self.prop_delay_ms = np.broadcast_to(
            np.asarray(
                0.0 if prop_delay_ms is None else prop_delay_ms, np.float64
            ),
            (self.n_links,),
        ).copy()

        # reentrant: transfer() queries the delta/load processes through the
        # public accessors below while already holding the lock. The lock
        # also guards those accessors when called directly, because stateful
        # load processes (Markov on/off) lazily extend shared timeline state
        # and may be queried from the consumer thread while the CacheBuilder
        # thread is inside transfer().
        self._lock = threading.RLock()
        # opt-in runtime sanitizer (REPRO_SANITIZE=1 or sanitize=True):
        # _transfer_locked asserts the lock is actually held on entry
        self._sanitize = _sanitizer.sanitize_enabled(sanitize)
        # greentrace: per-requester tracer slots (None until a traced worker
        # registers via set_tracer), guarded by the lock. A plain optional
        # list, so the fabric never imports repro_torch.obs and the
        # untraced path costs one None check per transfer.
        self._tracers: list | None = None
        self.reset()

    def set_tracer(self, requester: int, tracer) -> None:
        """Register a worker's tracer for per-transfer span emission
        (queue/service/propagation decomposition per owner link)."""
        with self._lock:
            if self._tracers is None:
                self._tracers = [None] * self.n_requesters
            self._tracers[int(requester)] = tracer

    # ------------------------------------------------------------- clock
    def reset(self) -> None:
        with self._lock:
            self.clock = NetClock()
            self.free_at = np.zeros(self.n_links, np.float64)
            # one ingress slot per requester (legacy mode: slot 0)
            self._shared_free_at = np.zeros(self.n_requesters, np.float64)
            self.total_queue_s = 0.0
            self.n_transfers = 0
            # per-requester attribution (satellite: congestion provenance)
            self.req_bytes = np.zeros(self.n_requesters, np.float64)
            self.req_rpcs = np.zeros(self.n_requesters, np.int64)
            self.req_transfers = np.zeros(self.n_requesters, np.int64)
            self.req_queue_s = np.zeros(self.n_requesters, np.float64)
            self.req_wall_s = np.zeros(self.n_requesters, np.float64)

    @property
    def shared_free_at(self) -> float:
        """Legacy scalar view of requester 0's ingress slot."""
        with self._lock:
            return float(self._shared_free_at[0])

    @shared_free_at.setter
    def shared_free_at(self, v: float) -> None:
        with self._lock:
            self._shared_free_at[0] = float(v)

    def tick(self, t_s: float, step: int = 0, epoch: int = 0) -> None:
        """Advance the fabric's virtual clock (called once per train step)."""
        with self._lock:
            self.clock = NetClock(float(t_s), int(step), int(epoch))

    # ------------------------------------------------------------ telemetry
    def _slice(self, values: np.ndarray, requester: int | None) -> np.ndarray:
        """Project per-link values onto a requester's remote-owner slots."""
        if requester is None or self.n_parts is None:
            return values
        return values[self._links_of[int(requester)]]

    def delta_ms(
        self, clock: NetClock | None = None, requester: int | None = None
    ) -> np.ndarray:
        """Injected per-link delay [ms] at the given (or current) clock.

        ``requester`` (cluster mode) returns the values at that rank's
        remote-owner links, in requester-relative slot order.
        """
        with self._lock:
            clock = clock or self.clock
            if self.delta_process is None:
                return self._slice(np.zeros(self.n_links), requester)
            return self._slice(
                np.asarray(
                    self.delta_process.delta_ms(clock, self.n_links),
                    np.float64,
                ),
                requester,
            )

    def utilization(
        self, clock: NetClock | None = None, requester: int | None = None
    ) -> np.ndarray:
        """Background per-link utilization in [0, MAX_UTILIZATION]."""
        with self._lock:
            clock = clock or self.clock
            if self.load_process is None:
                return self._slice(np.zeros(self.n_links), requester)
            u = np.asarray(
                self.load_process.utilization(clock, self.n_links),
                np.float64,
            )
            return self._slice(np.clip(u, 0.0, MAX_UTILIZATION), requester)

    def sigma(
        self, clock: NetClock | None = None, requester: int | None = None
    ) -> np.ndarray:
        """Effective per-link service-time multiplier (>= 1).

        Generalizes the paper's ``sigma = 1 + (gamma_c/beta) * delta`` to
        also account for bandwidth stolen by background traffic.
        """
        with self._lock:
            clock = clock or self.clock
            d = self.delta_ms(clock, requester)
            u = self.utilization(clock, requester)
        return (1.0 + self.slope * d) / (1.0 - u)

    def requester_metrics(self) -> list[dict]:
        """Per-requester traffic attribution (bytes, RPCs, latency, queue).

        ``queue_s`` is time this requester's transfers spent waiting behind
        traffic already occupying a NIC/ingress — including its OWN earlier
        transfers (a miss fetch queueing behind the same worker's in-flight
        rebuild counts too, so it can be nonzero even at P=1). Isolating
        the cross-worker share needs a silent-peers baseline (the
        live-vs-silent comparison in ``tests/test_cluster.py``);
        ``ClusterReport`` uses these tallies to attribute contention to
        its source worker.
        """
        with self._lock:
            return [
                {
                    "bytes": float(self.req_bytes[r]),
                    "n_rpcs": int(self.req_rpcs[r]),
                    "n_transfers": int(self.req_transfers[r]),
                    "queue_s": float(self.req_queue_s[r]),
                    "wall_s": float(self.req_wall_s[r]),
                    "mean_transfer_s": float(
                        self.req_wall_s[r] / max(self.req_transfers[r], 1)
                    ),
                }
                for r in range(self.n_requesters)
            ]

    # ------------------------------------------------------------- transfer
    def transfer(
        self,
        per_owner_rows: np.ndarray,
        bytes_per_row: float,
        at_s: float | None = None,
        chunk: int | None = None,
        concurrency: int = 1,
        requester: int = 0,
        clock: NetClock | None = None,
    ) -> TransferResult:
        """Issue one bulk (or chunked) fetch across owners; advance queues.

        ``per_owner_rows[o]`` feature rows are pulled from owner ``o``,
        concurrently across owners. ``chunk`` switches to the fine-grained
        DistTensor regime: ceil(rows/chunk) RPCs per owner with
        ``concurrency`` in flight (initiation cost paid ~n/Q times on the
        wall, n times on the CPU), and the pipelined 0.5*RTT propagation
        instead of the bulk 2*RTT.

        Cluster mode: ``per_owner_rows`` is in ``requester``-relative slot
        order (rank ``r``'s slot ``i`` is global owner ``i`` skipping
        ``r``), and ``clock`` supplies the requester's own virtual time
        (workers sharing one fabric each keep their own clock; the fabric's
        ticked clock is only a fallback for single-requester use).
        """
        rows = np.asarray(per_owner_rows, np.float64).ravel()
        requester = int(requester)
        links = self._links_of[requester if self.n_parts is not None else 0]
        if rows.shape != links.shape:
            raise ValueError(
                f"per_owner_rows has shape {rows.shape}, "
                f"fabric has {len(links)} owner links"
            )
        active = rows > 0
        if not active.any():
            return dataclasses.replace(_ZERO, per_owner_s=np.zeros(len(links)))

        with self._lock:
            return self._transfer_locked(
                rows, active, links, bytes_per_row, at_s, chunk,
                concurrency, requester, clock,
            )

    def _transfer_locked(
        self,
        rows: np.ndarray,
        active: np.ndarray,
        links: np.ndarray,
        bytes_per_row: float,
        at_s: float | None,
        chunk: int | None,
        concurrency: int,
        requester: int,
        clock: NetClock | None,
    ) -> TransferResult:
        """The transfer body; caller must hold ``self._lock``."""
        if self._sanitize:
            _sanitizer.assert_lock_held(self._lock, "Fabric._transfer_locked")
        clock = clock or self.clock
        t0 = float(at_s) if at_s is not None else clock.t_s
        if at_s is not None:
            clock = dataclasses.replace(clock, t_s=t0)
        delta = self.delta_ms(clock)         # per link
        util = self.utilization(clock)       # per link

        payload = rows * bytes_per_row
        per_owner_s = np.zeros(len(links))   # requester-relative slots
        wire_done = np.zeros(len(links))
        cpu = 0.0
        queue_s = 0.0
        n_rpcs = 0

        # greentrace: per-owner queue/service/prop decomposition, collected
        # only when this requester registered an enabled tracer
        tr = None
        if self._tracers is not None:
            cand = self._tracers[requester]
            if cand is not None and cand.enabled:
                tr = cand
                ready_arr = np.zeros(len(links))
                start_arr = np.zeros(len(links))
                q_arr = np.zeros(len(links))
                svc_arr = np.zeros(len(links))
                prop_arr = np.zeros(len(links))

        for o in np.flatnonzero(active):
            lnk = links[o]
            if chunk:
                n_chunks = int(np.ceil(rows[o] / chunk))
                init_wall = (
                    max(n_chunks / max(concurrency, 1), 1.0) * self.alpha
                )
            else:
                n_chunks = 1
                init_wall = self.alpha
            ready = t0 + init_wall
            start = max(ready, self.free_at[lnk])
            queue_s += start - ready
            # fluid service law, the twin of queue_sim/cluster_sim's phi
            service = (
                (1.0 - util[lnk])
                / (1.0 + self.slope * delta[lnk])
            )
            rate_eff = self.link_rate[lnk] * service
            finish = start + payload[o] / rate_eff
            self.free_at[lnk] = finish
            wire_done[o] = finish
            if tr is not None:
                ready_arr[o] = ready
                start_arr[o] = start
                q_arr[o] = start - ready
                svc_arr[o] = payload[o] / rate_eff
            cpu += n_chunks * self.alpha + payload[o] * (
                self.beta + self.gamma_c * delta[lnk]
            )
            n_rpcs += n_chunks

        # ---- shared ingress bottleneck (per-requester NIC) ----
        if self.shared_rate is not None:
            u_sh = 0.0
            if self.shared_load_process is not None:
                u_sh = min(
                    float(
                        self.shared_load_process.utilization(clock, 1)[0]
                    ),
                    MAX_UTILIZATION,
                )
            rate_sh = self.shared_rate * (1.0 - u_sh)
            free_sh = float(self._shared_free_at[requester])
            idx = np.flatnonzero(active)
            if self.discipline == "ps":
                # processor sharing: concurrent responses split the hop;
                # approximate equal-progress completion — everyone is done
                # after the aggregate drains from the last arrival.
                arrive = wire_done[idx]
                done = max(
                    float(arrive.max()), free_sh
                ) + float(payload[idx].sum()) / rate_sh
                queue_s += max(
                    0.0,
                    float(np.sum(done - arrive))
                    - float(payload[idx].sum()) / rate_sh,
                )
                if tr is not None:
                    # everyone pays its own drain share as service, the
                    # rest of (done - arrive) as queueing
                    q_arr[idx] += np.maximum(
                        0.0, done - arrive - payload[idx] / rate_sh
                    )
                    svc_arr[idx] += payload[idx] / rate_sh
                wire_done[idx] = done
                free_sh = done
            else:
                # FIFO in arrival order
                for o in idx[np.argsort(wire_done[idx], kind="stable")]:
                    s_start = max(wire_done[o], free_sh)
                    queue_s += s_start - wire_done[o]
                    s_finish = s_start + payload[o] / rate_sh
                    if tr is not None:
                        q_arr[o] += s_start - wire_done[o]
                        svc_arr[o] += payload[o] / rate_sh
                    free_sh = s_finish
                    wire_done[o] = s_finish
            self._shared_free_at[requester] = free_sh

        prop_factor = (
            cm.PROP_RTT_CHUNKED_S_PER_MS if chunk else cm.PROP_RTT_BULK_S_PER_MS
        )
        for o in np.flatnonzero(active):
            per_owner_s[o] = (
                wire_done[o]
                - t0
                + prop_factor * (self.prop_delay_ms[links[o]] + delta[links[o]])
            )
            if tr is not None:
                prop_arr[o] = prop_factor * (
                    self.prop_delay_ms[links[o]] + delta[links[o]]
                )

        self.total_queue_s += queue_s
        self.n_transfers += 1
        nbytes = float(payload[active].sum())
        raw = float(per_owner_s.max())
        self.req_bytes[requester] += nbytes
        self.req_rpcs[requester] += n_rpcs
        self.req_transfers[requester] += 1
        self.req_queue_s[requester] += queue_s
        self.req_wall_s[requester] += raw
        if tr is not None:
            tr.span(
                "fabric", "chunked" if chunk else "bulk", t0, t0 + raw,
                step=clock.step, epoch=clock.epoch,
                args={
                    "requester": int(requester),
                    "bytes": nbytes,
                    "rpcs": int(n_rpcs),
                    "queue_s": float(queue_s),
                    "owners": [
                        {
                            "slot": int(o),
                            "link": int(links[o]),
                            "bytes": float(payload[o]),
                            "ready_s": float(ready_arr[o]),
                            "start_s": float(start_arr[o]),
                            "finish_s": float(wire_done[o]),
                            "queue_s": float(q_arr[o]),
                            "service_s": float(svc_arr[o]),
                            "prop_s": float(prop_arr[o]),
                        }
                        for o in np.flatnonzero(active)
                    ],
                },
            )
        return TransferResult(
            raw_s=raw,
            cpu_s=float(cpu),
            nbytes=nbytes,
            n_rpcs=int(n_rpcs),
            per_owner_s=per_owner_s,
            queue_s=float(queue_s),
        )


def probe_rpc(
    params: CostModelParams,
    rows: float,
    delta_ms: float,
    bytes_per_row: float,
    n_owners: int = 1,
    chunk: int | None = None,
    concurrency: int = 1,
) -> TransferResult:
    """One isolated transfer on a fresh constant-delta fabric (no queueing).

    The calibration cross-check sweeps this over a (payload, delta) grid and
    refits Eq. (4) from the measured times (``core/calibration.py``).
    """
    from repro_torch.net.background import ConstantDelta

    fabric = Fabric(
        params, n_owners, delta_process=ConstantDelta(delta_ms), name="probe"
    )
    per_owner = np.zeros(n_owners)
    per_owner[0] = rows
    return fabric.transfer(
        per_owner, bytes_per_row, at_s=0.0, chunk=chunk, concurrency=concurrency
    )
