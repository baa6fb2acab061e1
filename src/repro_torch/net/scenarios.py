"""Scenario registry: named congestion environments on the net fabric.

Port of ``repro/net/scenarios.py``: the same specs, builders and seeds.

A *scenario* is a recipe that builds a configured :class:`Fabric` from the
run's shape (owners, epochs, steps, seed, cost-model params). Selected via
``RunConfig.scenario``:

  ============== ===========================================================
  name            behavior
  ============== ===========================================================
  clean           idle links, zero injected delay (closed-form parity case)
  paper_schedule  the paper's Section VI-A epoch-level injection schedule
  fixed:<ms>      constant <ms> injected delay on every owner link
  bursty_markov   Markov on/off background bursts stealing link bandwidth
  diurnal         sinusoidal background load, phase-shifted per link
  incast          periodic synchronized bursts + a shared ingress
                  bottleneck all owner responses serialize through
  straggler       one persistently overloaded owner link (seeded choice)
  trace:<path>    replay a measured JSON/CSV delta-vs-time file
  arch_none .. arch_osc   the six legacy domain-randomization archetypes
                  (``core/domain_rand``) adapted onto the fabric
  ============== ===========================================================

``closed_form`` is also accepted and means "no fabric" — the trainer falls
back to the analytic ``alpha + 2*delta`` law (the pre-fabric behavior).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.cost_model import CostModelParams
from repro_torch.net import background as bg
from repro_torch.net.fabric import Fabric

# Sentinel scenario names that select the analytic path instead of a fabric.
CLOSED_FORM = ("closed_form", None)


class ScenarioRegistry:
    """Name -> fabric-builder mapping with ``prefix:arg`` spec support."""

    _builders: dict[str, Callable] = {}
    _prefixes: dict[str, Callable] = {}

    @classmethod
    def register(cls, name: str) -> Callable:
        def deco(fn: Callable) -> Callable:
            cls._builders[name] = fn
            return fn

        return deco

    @classmethod
    def register_prefix(cls, prefix: str) -> Callable:
        def deco(fn: Callable) -> Callable:
            cls._prefixes[prefix] = fn
            return fn

        return deco

    @classmethod
    def names(cls) -> list[str]:
        return sorted(cls._builders) + [
            f"{p}:<arg>" for p in sorted(cls._prefixes)
        ]

    @classmethod
    def build(
        cls,
        spec: str,
        params: CostModelParams,
        n_owners: int,
        seed: int = 0,
        n_epochs: int = 30,
        steps_per_epoch: int = 32,
        n_parts: int | None = None,
        n_requesters: int = 1,
    ) -> Fabric:
        """Instantiate the fabric for a scenario spec.

        ``n_parts``/``n_requesters`` select the requester-aware cluster
        topology (one shared NIC per partition; see ``net/fabric.py``);
        background processes are then sized per *global* owner link so all
        requesters observe one consistent overlay world.
        """
        if spec in CLOSED_FORM:
            raise ValueError(
                "closed_form is the analytic fallback, not a fabric scenario"
            )
        ctx = dict(
            params=params, n_owners=n_owners, seed=seed,
            n_epochs=n_epochs, steps_per_epoch=steps_per_epoch,
            n_parts=n_parts, n_requesters=n_requesters,
        )
        if spec in cls._builders:
            return cls._builders[spec](**ctx)
        if ":" in spec:
            prefix, arg = spec.split(":", 1)
            if prefix in cls._prefixes:
                return cls._prefixes[prefix](arg, **ctx)
        raise KeyError(
            f"unknown scenario {spec!r}; available: {', '.join(cls.names())}"
        )


def build_scenario(spec: str, **kw) -> Fabric:
    """Module-level convenience wrapper around :meth:`ScenarioRegistry.build`."""
    return ScenarioRegistry.build(spec, **kw)


def _links(n_owners: int, n_parts: int | None) -> int:
    """Number of NIC links a scenario's processes must cover (cluster mode
    has one per partition, legacy mode one per remote owner)."""
    return n_parts if n_parts is not None else n_owners


# ---------------------------------------------------------------------------
# Training twins: the queue-aware training env (core/queue_sim.py) samples
# episodes from the SAME archetype names this registry evaluates. These
# helpers export registry specs as its scenario codes (the package's one
# table, ``queue_sim.SCENARIO_CODES``) so a training pool can be declared in
# eval vocabulary.
# ---------------------------------------------------------------------------

def queue_training_code(spec: str) -> int:
    """Queue-sim training code for one registry spec (``fixed:10`` and
    ``trace:<path>`` map to their parametric training families)."""
    from repro_torch.core.queue_sim import code_for

    return code_for(spec)


def queue_training_pool(specs=None) -> tuple[int, ...]:
    """Queue-sim scenario-code pool for a list of registry specs (default:
    the full scenario-conditioned domain-randomization pool)."""
    from repro_torch.core import queue_sim

    if specs is None:
        return queue_sim.default_training_pool()
    return tuple(queue_sim.code_for(s) for s in specs)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

@ScenarioRegistry.register("clean")
def _clean(params, n_owners, seed, n_epochs, steps_per_epoch,
           n_parts=None, n_requesters=1) -> Fabric:
    return Fabric(params, n_owners, name="clean",
                  n_parts=n_parts, n_requesters=n_requesters)


@ScenarioRegistry.register("paper_schedule")
def _paper_schedule(params, n_owners, seed, n_epochs, steps_per_epoch,
                    n_parts=None, n_requesters=1):
    return Fabric(
        params, n_owners,
        delta_process=bg.PaperScheduleDelta(n_epochs, steps_per_epoch),
        name="paper_schedule",
        n_parts=n_parts, n_requesters=n_requesters,
    )


def _run_duration_s(params, n_epochs: int, steps_per_epoch: int) -> float:
    """Expected virtual run length — generator timescales are expressed as
    fractions of it, so bursts/cycles materialize at ANY --steps budget."""
    return max(n_epochs * steps_per_epoch * float(params.t_base), 1e-3)


@ScenarioRegistry.register("bursty_markov")
def _bursty_markov(params, n_owners, seed, n_epochs, steps_per_epoch,
                   n_parts=None, n_requesters=1):
    dur = _run_duration_s(params, n_epochs, steps_per_epoch)
    return Fabric(
        params, n_owners,
        load_process=bg.MarkovOnOffLoad(
            _links(n_owners, n_parts), mean_on_s=0.03 * dur,
            mean_off_s=0.07 * dur, util_on=0.85, seed=seed,
        ),
        name="bursty_markov",
        n_parts=n_parts, n_requesters=n_requesters,
    )


@ScenarioRegistry.register("diurnal")
def _diurnal(params, n_owners, seed, n_epochs, steps_per_epoch,
             n_parts=None, n_requesters=1):
    dur = _run_duration_s(params, n_epochs, steps_per_epoch)
    return Fabric(
        params, n_owners,
        load_process=bg.DiurnalLoad(
            period_s=0.4 * dur, amplitude=0.7, seed=seed,
            n_links=_links(n_owners, n_parts),
        ),
        name="diurnal",
        n_parts=n_parts, n_requesters=n_requesters,
    )


@ScenarioRegistry.register("incast")
def _incast(params, n_owners, seed, n_epochs, steps_per_epoch,
            n_parts=None, n_requesters=1):
    # shared ingress slightly above a single link's rate: concurrent owner
    # responses must serialize, so multi-owner fetches see incast collapse
    dur = _run_duration_s(params, n_epochs, steps_per_epoch)
    return Fabric(
        params, n_owners,
        load_process=bg.IncastLoad(
            period_s=0.08 * dur, burst_s=0.015 * dur, util=0.9, seed=seed
        ),
        shared_rate=1.5 / float(params.beta),
        discipline="fifo",
        name="incast",
        n_parts=n_parts, n_requesters=n_requesters,
    )


@ScenarioRegistry.register("straggler")
def _straggler(params, n_owners, seed, n_epochs, steps_per_epoch,
               n_parts=None, n_requesters=1):
    return Fabric(
        params, n_owners,
        load_process=bg.StragglerLoad(
            _links(n_owners, n_parts), util=0.7, seed=seed
        ),
        name="straggler",
        n_parts=n_parts, n_requesters=n_requesters,
    )


@ScenarioRegistry.register_prefix("fixed")
def _fixed(arg, params, n_owners, seed, n_epochs, steps_per_epoch,
           n_parts=None, n_requesters=1):
    return Fabric(
        params, n_owners,
        delta_process=bg.ConstantDelta(float(arg)),
        name=f"fixed:{arg}",
        n_parts=n_parts, n_requesters=n_requesters,
    )


@ScenarioRegistry.register_prefix("trace")
def _trace(arg, params, n_owners, seed, n_epochs, steps_per_epoch,
           n_parts=None, n_requesters=1):
    from repro_torch.net.trace_replay import load_trace

    return Fabric(
        params, n_owners,
        delta_process=bg.TraceDelta(load_trace(arg)),
        name=f"trace:{arg}",
        n_parts=n_parts, n_requesters=n_requesters,
    )


# the six legacy domain-randomization archetypes (core/domain_rand), with
# onset after the warmup epochs and severity at the eval midpoint
_ARCHETYPES = {
    "arch_none": 0, "arch_slow": 1, "arch_switch": 2,
    "arch_two_sym": 3, "arch_two_asym": 4, "arch_osc": 5,
}


def _make_archetype(k: int):
    def builder(params, n_owners, seed, n_epochs, steps_per_epoch,
                n_parts=None, n_requesters=1):
        import numpy as np

        rng = np.random.default_rng((seed, 0xA2C, k))
        total = n_epochs * steps_per_epoch
        nl = _links(n_owners, n_parts)
        link_a = int(rng.integers(0, max(nl, 1)))
        link_b = (link_a + 1) % max(nl, 1)
        return Fabric(
            params, n_owners,
            delta_process=bg.ArchetypeDelta(
                archetype=k, severity_ms=20.0,
                onset=0.15 * total, duration=0.7 * total,
                period=64.0, link_a=link_a, link_b=link_b,
                phase=float(rng.uniform(0.0, 2.0 * np.pi)),
            ),
            name=f"arch_{k}",
            n_parts=n_parts, n_requesters=n_requesters,
        )

    return builder


for _name, _k in _ARCHETYPES.items():
    ScenarioRegistry._builders[_name] = _make_archetype(_k)
