"""greentrace: structured event tracing on the simulator's virtual clocks.

Port of ``repro/obs/tracer.py``. Every event is stamped with the virtual
time the cluster runs on (``EnergyMeter.wall_s`` / ``NetClock.t_s``),
never the host clock, so traces of same-seed modeled runs are
bit-identical byte streams, equal to the reference's. Events that mirror
an ``EnergyMeter.record_*`` call carry the *exact* (gpu_j, cpu_j)
increments, computed in Python float64 by the same pure charge laws in
:mod:`repro_torch.core.energy` that the meter itself uses, which makes the
trace a second, auditable energy ledger: replaying the charges of a rank's
event stream in emission order reproduces the meter totals bit for bit
(:func:`reconcile`).

The disabled tracer is a null object. Hot paths guard emission with a
single attribute read (``if tracer.enabled:``) so that with
``RunConfig.trace=False`` no event dict is ever constructed and the
modeled lane is untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.energy import (
    StepSample,
    background_charges,
    step_charges,
    sync_charges,
)

SCHEMA = "greentrace-v1"

# Event kinds. "charge" events are the energy ledger (carry gpu_j/cpu_j and
# participate in reconciliation); the rest decorate the timeline.
KIND_CHARGE = "charge"
KIND_SPAN = "span"
KIND_INSTANT = "instant"
KIND_COUNTER = "counter"


class ReconciliationError(AssertionError):
    """Traced joules do not sum bit-exactly to the meter totals."""


@dataclasses.dataclass
class Tracer:
    """Per-rank event recorder.

    ``events`` is append-only; per-rank emission order is the ledger order.
    ``gpu_j``/``cpu_j`` shadow the rank's meter via the same increments, so a
    divergence is caught at emission time, not only at export.
    """

    rank: int
    params: Any  # CostModelParams — power constants for the charge laws
    enabled: bool = True
    window: int = 0  # current rebuild-window ordinal (worker bumps it)
    events: list = dataclasses.field(default_factory=list)
    gpu_j: float = 0.0
    cpu_j: float = 0.0

    # ---- raw emission -----------------------------------------------------
    def emit(self, kind: str, component: str, name: str, t0: float,
             t1: float | None = None, *, step: int = -1, epoch: int = -1,
             gpu_j: float | None = None, cpu_j: float | None = None,
             args: dict | None = None) -> None:
        ev = {
            "kind": kind,
            "component": component,
            "name": name,
            "rank": self.rank,
            "window": self.window,
            "t0": float(t0),
            "t1": float(t1 if t1 is not None else t0),
            "step": int(step),
            "epoch": int(epoch),
        }
        if gpu_j is not None:
            ev["gpu_j"] = float(gpu_j)
            ev["cpu_j"] = float(cpu_j)
        if args:
            ev["args"] = args
        self.events.append(ev)

    # ---- timeline decoration ----------------------------------------------
    def span(self, component: str, name: str, t0: float, t1: float, *,
             step: int = -1, epoch: int = -1, args: dict | None = None) -> None:
        self.emit(KIND_SPAN, component, name, t0, t1, step=step, epoch=epoch,
                  args=args)

    def instant(self, component: str, name: str, t0: float, *,
                step: int = -1, epoch: int = -1,
                args: dict | None = None) -> None:
        self.emit(KIND_INSTANT, component, name, t0, step=step, epoch=epoch,
                  args=args)

    def counter(self, component: str, name: str, t0: float, *,
                step: int = -1, epoch: int = -1,
                args: dict | None = None) -> None:
        self.emit(KIND_COUNTER, component, name, t0, step=step, epoch=epoch,
                  args=args)

    def begin_window(self, t0: float, *, step: int = -1, epoch: int = -1,
                     args: dict | None = None) -> None:
        """Advance the rebuild-window ordinal; later events tag the new one."""
        self.window += 1
        self.instant("window", "begin", t0, step=step, epoch=epoch, args=args)

    # ---- the energy ledger ------------------------------------------------
    # One charge event per EnergyMeter.record_* call, same increments, same
    # order. Callers pass t0 = meter.wall_s *before* the record call.
    def charge_step(self, t0: float, sample: StepSample, *,
                    component: str = "step", name: str = "step",
                    step: int = -1, epoch: int = -1,
                    args: dict | None = None) -> None:
        gpu, cpu = step_charges(self.params, sample)
        self.gpu_j += gpu
        self.cpu_j += cpu
        a = dict(args) if args else {}
        a.setdefault("compute_s", float(sample.t_compute))
        a.setdefault("stall_s", float(sample.t_stall))
        a.setdefault("cpu_comm_s", float(sample.t_cpu_comm))
        a.setdefault("gpu_overlap", float(sample.gpu_overlap))
        a.setdefault("bytes", float(sample.remote_bytes))
        a.setdefault("rpcs", int(sample.n_rpcs))
        self.emit(KIND_CHARGE, component, name, t0,
                  t0 + (sample.t_compute + sample.t_stall), step=step,
                  epoch=epoch, gpu_j=gpu, cpu_j=cpu, args=a)

    def charge_background(self, t0: float, cpu_s: float, *,
                          component: str = "rebuild", name: str = "background",
                          step: int = -1, epoch: int = -1,
                          args: dict | None = None) -> None:
        gpu, cpu = background_charges(self.params, cpu_s)
        self.gpu_j += gpu
        self.cpu_j += cpu
        a = dict(args) if args else {}
        a.setdefault("cpu_comm_s", float(cpu_s))
        self.emit(KIND_CHARGE, component, name, t0, step=step, epoch=epoch,
                  gpu_j=gpu, cpu_j=cpu, args=a)

    def charge_sync(self, t0: float, stall_s: float, cpu_comm_s: float = 0.0,
                    *, component: str = "collective", name: str = "sync",
                    step: int = -1, epoch: int = -1,
                    args: dict | None = None) -> None:
        gpu, cpu = sync_charges(self.params, stall_s, cpu_comm_s)
        self.gpu_j += gpu
        self.cpu_j += cpu
        a = dict(args) if args else {}
        a.setdefault("stall_s", float(stall_s))
        a.setdefault("cpu_comm_s", float(cpu_comm_s))
        self.emit(KIND_CHARGE, component, name, t0, t0 + stall_s, step=step,
                  epoch=epoch, gpu_j=gpu, cpu_j=cpu, args=a)

    # ---- export surface ---------------------------------------------------
    def section(self, meter) -> dict:
        """Per-rank slice of the trace payload, with the meter totals the
        ledger must reconcile against."""
        return {
            "rank": self.rank,
            "meter": {
                "gpu_j": float(meter.gpu_j),
                "cpu_j": float(meter.cpu_j),
                "wall_s": float(meter.wall_s),
            },
            "events": self.events,
        }


class NullTracer:
    """Disabled tracer: ``enabled`` is False and every method is a no-op.

    Hot paths never reach the methods (they guard on ``enabled``), but the
    null object keeps cold paths branch-free too.
    """

    enabled = False
    rank = -1
    window = 0
    events: tuple = ()

    def emit(self, *a, **k) -> None:
        pass

    def span(self, *a, **k) -> None:
        pass

    def instant(self, *a, **k) -> None:
        pass

    def counter(self, *a, **k) -> None:
        pass

    def begin_window(self, *a, **k) -> None:
        pass

    def charge_step(self, *a, **k) -> None:
        pass

    def charge_background(self, *a, **k) -> None:
        pass

    def charge_sync(self, *a, **k) -> None:
        pass

    def section(self, meter) -> None:
        return None


NULL_TRACER = NullTracer()


# ---- reconciliation -------------------------------------------------------
def ledger_totals(events) -> tuple[float, float]:
    """Replay a rank's charge events in emission order (bit-exact)."""
    gpu = 0.0
    cpu = 0.0
    for ev in events:
        if ev["kind"] == KIND_CHARGE:
            gpu += ev["gpu_j"]
            cpu += ev["cpu_j"]
    return gpu, cpu


def component_totals(events) -> dict:
    """Traced joules grouped by component (reporting surface; the bit-exact
    gate is the ordered replay in :func:`ledger_totals`)."""
    out: dict = {}
    for ev in events:
        if ev["kind"] != KIND_CHARGE:
            continue
        row = out.setdefault(ev["component"], {"gpu_j": 0.0, "cpu_j": 0.0})
        row["gpu_j"] += ev["gpu_j"]
        row["cpu_j"] += ev["cpu_j"]
    return out


def reconcile(payload: dict) -> dict:
    """Assert the headline invariant: per-rank traced joules sum *bit-exactly*
    to the meter totals recorded in the payload. Returns per-rank totals
    (with per-component breakdown) on success; raises
    :class:`ReconciliationError` on any mismatch.
    """
    out = {}
    for sec in payload["ranks"]:
        rank = sec["rank"]
        gpu, cpu = ledger_totals(sec["events"])
        m = sec["meter"]
        if gpu != m["gpu_j"] or cpu != m["cpu_j"]:
            raise ReconciliationError(
                f"rank {rank}: traced ledger (gpu_j={gpu!r}, cpu_j={cpu!r}) "
                f"!= meter (gpu_j={m['gpu_j']!r}, cpu_j={m['cpu_j']!r}); "
                f"delta=({gpu - m['gpu_j']:+.3e}, {cpu - m['cpu_j']:+.3e})"
            )
        out[rank] = {
            "gpu_j": gpu,
            "cpu_j": cpu,
            "components": component_totals(sec["events"]),
        }
    return out
