"""greentrace: virtual-time structured tracing with per-joule attribution.

Port of ``repro/obs``. See :mod:`repro_torch.obs.tracer` for the event
model and the reconciliation invariant, :mod:`repro_torch.obs.export` for
canonical JSON + Perfetto export, :mod:`repro_torch.obs.report` for the
"where did the joules go" analyzer, and :mod:`repro_torch.obs.reduce` for
the shared telemetry merge helper. ``python -m repro_torch.obs
report|capture`` is the command line.
"""
from repro_torch.obs.export import (
    build_payload,
    dumps_canonical,
    load_trace,
    run_meta,
    to_chrome,
    trace_digest,
    write_chrome,
    write_trace,
)
from repro_torch.obs.reduce import merge_counters
from repro_torch.obs.tracer import (
    NULL_TRACER,
    NullTracer,
    ReconciliationError,
    Tracer,
    component_totals,
    ledger_totals,
    reconcile,
)

__all__ = [
    "NULL_TRACER",
    "NullTracer",
    "ReconciliationError",
    "Tracer",
    "build_payload",
    "component_totals",
    "dumps_canonical",
    "ledger_totals",
    "load_trace",
    "merge_counters",
    "reconcile",
    "run_meta",
    "to_chrome",
    "trace_digest",
    "write_chrome",
    "write_trace",
]
