"""Rule family ``obs``: every metered joule in a traced component is traced.

The greentrace reconciliation invariant (traced charge events sum
bit-exactly to the ``EnergyMeter`` totals) only holds if every
``meter.record_*`` call in an instrumented module has a paired tracer
charge emission in the same function. The seed bug class: someone adds a
new ``record_step``/``record_background``/``record_sync`` call (a new
energy sink) and forgets the matching ``tracer.charge_*`` — reconciliation
then fails at runtime, but only on code paths the fast tests happen to
exercise. This rule turns the pairing into a static invariant.

Scope: modules that actually participate in tracing — i.e. files that
reference a tracer at all (``self.tracer`` / ``Tracer`` / ``NULL_TRACER``).
Un-traced components (benchmarks driving a bare meter, unit tests) are
outside the contract and never flagged.

Mechanics, per function in a traced module:
  1. collect meter recording calls: attribute calls named ``record_step``,
     ``record_background`` or ``record_sync``;
  2. collect tracer charge emissions: attribute calls named
     ``charge_step``, ``charge_background`` or ``charge_sync`` — or calls
     to a same-module function that itself contains one (one level of
     indirection: ``self._trace_step(...)`` helpers count);
  3. flag each recording call in a function with NO charge emission.
     (The pairing is per-function, not per-call: one guarded
     ``if self.tracer.enabled:`` block may cover several meter calls.)

Suppress a deliberate untraced record with ``# greenlint: obs-ok <why>``
(e.g. a warmup path whose joules are charged elsewhere).
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import Finding, ProjectIndex, SourceFile

RULE = "obs"

_RECORD_CALLS = frozenset({
    "record_step", "record_background", "record_sync",
})
_CHARGE_CALLS = frozenset({
    "charge_step", "charge_background", "charge_sync",
})
_TRACER_NAMES = frozenset({"Tracer", "NullTracer", "NULL_TRACER", "tracer"})

# modules outside the tracing contract even though they may mention a
# tracer: the tracer implementation itself and the meter it mirrors
_EXEMPT_PREFIXES = ("obs/", "core/energy")


def _is_traced_module(file: SourceFile) -> bool:
    """A module participates in tracing if it names a tracer anywhere."""
    for node in ast.walk(file.tree):
        if isinstance(node, ast.Name) and node.id in _TRACER_NAMES:
            return True
        if isinstance(node, ast.Attribute) and node.attr == "tracer":
            return True
    return False


def _call_name(node: ast.Call) -> str:
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _charging_helpers(tree: ast.Module) -> frozenset[str]:
    """Names of same-module functions that contain a charge emission —
    calls to these count as charging (one level of indirection, so
    ``self._trace_step(...)`` helpers satisfy the pairing)."""
    out = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and _call_name(sub) in _CHARGE_CALLS:
                out.add(node.name)
                break
    return frozenset(out)


def check(file: SourceFile, index: ProjectIndex) -> Iterator[Finding]:
    if file.path.startswith(_EXEMPT_PREFIXES):
        return
    if not _is_traced_module(file):
        return
    helpers = _charging_helpers(file.tree)
    for node in ast.walk(file.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        records: list[tuple[str, ast.Call]] = []
        has_charge = False
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            name = _call_name(sub)
            if name in _RECORD_CALLS:
                records.append((name, sub))
            elif name in _CHARGE_CALLS or name in helpers:
                has_charge = True
        if has_charge:
            continue
        for name, call in records:
            if file.suppressed(call.lineno, "obs-ok"):
                continue
            yield Finding(
                rule="obs/meter-untraced",
                path=file.path,
                line=call.lineno,
                col=call.col_offset,
                message=(
                    f"{file.path}: function '{node.name}' calls meter."
                    f"{name} but emits no tracer charge_* — the greentrace "
                    f"ledger will not reconcile on this path (pair it with "
                    f"the matching tracer.charge_* or mark "
                    f"'# greenlint: obs-ok <why>')"
                ),
            )
