"""Background-traffic and injected-delay processes for the net fabric.

Port of ``repro/net/background.py`` (numpy float64, the reference's RNG
streams and seeds, so every process gives the same timeline).

Two process families plug into a ``Fabric``:

  * **delta processes** — per-owner injected one-way delay [ms]; the
    fabric maps delta to a service slowdown via the calibrated slope
    ``gamma_c / beta`` (exactly Eq. 8's sigma) plus a propagation RTT term;
  * **load processes** — per-link background utilization u(t) in [0, 1):
    foreign traffic stealing bandwidth, so the effective serialization
    rate is ``rate * (1 - u)``. This is the piece the closed form cannot
    express at all.

Every process is a pure function of (seeded RNG state, virtual clock), so
runs are bit-reproducible. Stateful generators (Markov on/off) lazily
extend a pre-seeded switch-time timeline; extension depends only on the
per-link RNG stream, never on call order across links.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import domain_rand as dr
from repro_torch.net.fabric import NetClock


# ---------------------------------------------------------------------------
# Delta processes (injected per-owner delay, ms)
# ---------------------------------------------------------------------------

def _per_link(values: np.ndarray, n_links: int, what: str) -> np.ndarray:
    """Broadcast a scalar to every link; a vector must match exactly."""
    if values.size == 1:
        return np.full(n_links, values[0])
    if values.size != n_links:
        raise ValueError(
            f"{what} has {values.size} entries, fabric has {n_links} links"
        )
    return values


class ConstantDelta:
    """Fixed injected delay; scalar (all links) or per-owner vector."""

    def __init__(self, delta_ms):
        self._delta = np.asarray(delta_ms, np.float64).ravel()

    def delta_ms(self, clock: NetClock, n_owners: int) -> np.ndarray:
        return _per_link(self._delta, n_owners, "ConstantDelta")


class PaperScheduleDelta:
    """The paper's Section VI-A epoch-level injection schedule."""

    def __init__(self, n_epochs: int, steps_per_epoch: int):
        self.n_epochs = int(n_epochs)
        self.steps_per_epoch = int(steps_per_epoch)

    def delta_ms(self, clock: NetClock, n_owners: int) -> np.ndarray:
        epoch = clock.step // max(self.steps_per_epoch, 1)
        return dr.paper_schedule_delta_np(epoch, self.n_epochs, n_owners)


class ArchetypeDelta:
    """One of the six legacy domain-randomization archetypes, step-indexed.

    Adapts ``core/domain_rand.delta_at_np`` onto the fabric so the DQN's
    training family is also available as live scenarios
    (``arch_none`` ... ``arch_osc``).
    """

    def __init__(
        self,
        archetype: int,
        severity_ms: float = 15.0,
        onset: float = 32.0,
        duration: float = 1e9,
        period: float = 64.0,
        link_a: int = 0,
        link_b: int = 1,
        phase: float = 0.0,
    ):
        self.kw = dict(
            archetype=int(archetype), severity_ms=float(severity_ms),
            onset=float(onset), duration=float(duration),
            period=float(period), link_a=int(link_a), link_b=int(link_b),
            phase=float(phase),
        )

    def delta_ms(self, clock: NetClock, n_owners: int) -> np.ndarray:
        return dr.delta_at_np(step=clock.step, n_owners=n_owners, **self.kw)


class TraceDelta:
    """Replay a measured delta-vs-time trace (see ``net/trace_replay.py``)."""

    def __init__(self, trace, time_scale: float = 1.0):
        self.trace = trace
        self.time_scale = float(time_scale)

    def delta_ms(self, clock: NetClock, n_owners: int) -> np.ndarray:
        return self.trace.delta_ms(clock.t_s * self.time_scale, n_owners)


# ---------------------------------------------------------------------------
# Load processes (background utilization per link, dimensionless)
# ---------------------------------------------------------------------------

class ConstantLoad:
    """Fixed background utilization; scalar or per-link vector."""

    def __init__(self, util):
        self._util = np.asarray(util, np.float64).ravel()

    def utilization(self, clock: NetClock, n_links: int) -> np.ndarray:
        return _per_link(self._util, n_links, "ConstantLoad")


class StragglerLoad:
    """One persistently overloaded owner link (seeded choice)."""

    def __init__(self, n_links: int, util: float = 0.7, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.victim = int(rng.integers(0, max(n_links, 1)))
        self.util = float(util)

    def utilization(self, clock: NetClock, n_links: int) -> np.ndarray:
        u = np.zeros(n_links)
        u[self.victim % n_links] = self.util
        return u


class DiurnalLoad:
    """Sinusoidal background utilization (diurnal pattern, compressed)."""

    def __init__(
        self,
        period_s: float = 2.0,
        amplitude: float = 0.7,
        seed: int = 0,
        n_links: int = 3,
    ):
        rng = np.random.default_rng(seed)
        self.period_s = float(period_s)
        self.amplitude = float(amplitude)
        # each link peaks at a different time of "day"
        self.phase = rng.uniform(0.0, 2.0 * np.pi, size=max(n_links, 1))

    def utilization(self, clock: NetClock, n_links: int) -> np.ndarray:
        ph = np.resize(self.phase, n_links)
        s = np.sin(2.0 * np.pi * clock.t_s / self.period_s + ph)
        return self.amplitude * 0.5 * (1.0 + s)


class MarkovOnOffLoad:
    """Two-state bursty background traffic per link.

    Each link flips between OFF (u = 0) and ON (u = ``util_on``) with
    exponentially distributed sojourn times. The switch-time timeline is
    generated lazily from a per-link seeded RNG, so utilization at any
    virtual time is a deterministic function of (seed, t) regardless of
    query order.
    """

    def __init__(
        self,
        n_links: int,
        mean_on_s: float = 0.3,
        mean_off_s: float = 0.6,
        util_on: float = 0.85,
        seed: int = 0,
    ):
        self.mean = (float(mean_off_s), float(mean_on_s))  # state-indexed
        self.util_on = float(util_on)
        self._rngs = [
            np.random.default_rng((seed, 0x0FF0, i)) for i in range(n_links)
        ]
        # per link: list of switch times; state before switch k is k%2
        # (0 = OFF first). switch_times[i][k] is the k-th state change.
        self._switches: list[list[float]] = [[] for _ in range(n_links)]

    def _state_at(self, link: int, t: float) -> int:
        sw = self._switches[link]
        rng = self._rngs[link]
        while not sw or sw[-1] <= t:
            k = len(sw)
            state = k % 2  # state entered after k switches (0=OFF)
            prev = sw[-1] if sw else 0.0
            sw.append(prev + rng.exponential(self.mean[state]))
        # number of switches strictly before t = state index
        lo = int(np.searchsorted(np.asarray(sw), t, side="right"))
        return lo % 2

    def utilization(self, clock: NetClock, n_links: int) -> np.ndarray:
        t = max(clock.t_s, 0.0)
        return np.asarray(
            [
                self.util_on if self._state_at(i % len(self._rngs), t) else 0.0
                for i in range(n_links)
            ]
        )


class IncastLoad:
    """Periodic synchronized bursts saturating every link at once.

    Models the aggregation-tree incast pattern: for ``burst_s`` out of
    every ``period_s`` all owner links (and, via the scenario's shared
    bottleneck, the ingress) are near-saturated.
    """

    def __init__(
        self,
        period_s: float = 0.5,
        burst_s: float = 0.08,
        util: float = 0.9,
        seed: int = 0,
    ):
        rng = np.random.default_rng(seed)
        self.period_s = float(period_s)
        self.burst_s = float(burst_s)
        self.util = float(util)
        self.offset = float(rng.uniform(0.0, period_s))

    def utilization(self, clock: NetClock, n_links: int) -> np.ndarray:
        t = (clock.t_s + self.offset) % self.period_s
        return np.full(n_links, self.util if t < self.burst_s else 0.0)
