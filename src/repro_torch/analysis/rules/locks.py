"""Rule family ``locks``: lock-guarded shared state stays lock-guarded.

Classes that own a ``threading.Lock``/``RLock``/``Condition`` (the fabric,
the cluster step gate) protect their cross-thread shared state with
``with self._lock:`` blocks. The invariant this rule encodes: an
attribute that is ever *written* under the lock is shared mutable state,
so every OTHER access to it — read or write, in any method — must also
hold the lock. The seed bug class: a convenience property or late-added
telemetry accessor that reaches into guarded state directly, which is a
data race that only manifests as a torn read under real thread
interleavings (exactly what the deterministic lockstep tests can never
exercise).

Mechanics, per class owning a lock attribute:
  1. collect ``guarded`` = self-attributes written inside any
     ``with self.<lock>:`` block outside ``__init__`` (plain, augmented,
     and subscript stores all count: ``self.free_at[i] = t`` guards
     ``free_at``);
  2. flag any access (load or store) to a guarded attribute outside a
     ``with self.<lock>:`` block in any method except ``__init__``
     (object construction happens-before publication) and except
     ``*_locked``-suffixed methods, whose name declares the
     caller-holds-the-lock contract (the runtime sanitizer is the other
     half of that contract: such methods assert the lock on entry when
     ``REPRO_SANITIZE=1``).

Suppress a proven-safe access with ``# greenlint: lock-ok``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import Finding, ProjectIndex, SourceFile

RULE = "locks"

_LOCK_FACTORIES = frozenset({"Lock", "RLock", "Condition"})


def _lock_attrs_of(cls: ast.ClassDef) -> frozenset[str]:
    """self-attributes assigned a threading lock anywhere in the class."""
    out = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        if not isinstance(value, ast.Call):
            continue
        func = value.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else ""
        )
        if name not in _LOCK_FACTORIES:
            continue
        for tgt in node.targets:
            if (
                isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"
            ):
                out.add(tgt.attr)
    return frozenset(out)


def _self_attr(node: ast.expr) -> str | None:
    """'attr' when node is ``self.attr`` (or a subscript of it)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _is_lock_with_item(item: ast.withitem, lock_attrs: frozenset[str]) -> bool:
    attr = _self_attr(item.context_expr)
    return attr is not None and attr in lock_attrs


class _AccessCollector(ast.NodeVisitor):
    """Per-method: self-attr accesses partitioned by lock-held depth."""

    def __init__(self, lock_attrs: frozenset[str]):
        self.lock_attrs = lock_attrs
        self.depth = 0
        # (attr, node, is_write, lock_held)
        self.accesses: list[tuple[str, ast.AST, bool, bool]] = []

    def visit_With(self, node: ast.With) -> None:
        holds = any(_is_lock_with_item(i, self.lock_attrs) for i in node.items)
        for item in node.items:
            self.visit(item.context_expr)
        if holds:
            self.depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if holds:
            self.depth -= 1

    def visit_FunctionDef(self, node) -> None:
        # nested defs may run on another thread; analyze their bodies as
        # lock-free regardless of the enclosing with-block. Lambdas are
        # NOT reset: the dominant idiom is `cv.wait_for(lambda: ...)`,
        # whose predicate runs with the condition's lock held.
        saved, self.depth = self.depth, 0
        self.generic_visit(node)
        self.depth = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None and attr not in self.lock_attrs:
            is_write = isinstance(node.ctx, (ast.Store, ast.Del))
            self.accesses.append((attr, node, is_write, self.depth > 0))
        self.generic_visit(node)


def _methods(cls: ast.ClassDef):
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield stmt


def check(file: SourceFile, index: ProjectIndex) -> Iterator[Finding]:
    for node in ast.walk(file.tree):
        if isinstance(node, ast.ClassDef):
            yield from _check_class(file, node)


def _check_class(file: SourceFile, cls: ast.ClassDef) -> Iterator[Finding]:
    lock_attrs = _lock_attrs_of(cls)
    if not lock_attrs:
        return

    # (method node, collector) pairs — keyed by node, not name, so
    # property getter/setter pairs sharing a name stay distinct
    collected: list[tuple[object, _AccessCollector]] = []
    for m in _methods(cls):
        col = _AccessCollector(lock_attrs)
        # `*_locked` methods run under the caller's lock by contract
        col.depth = 1 if m.name.endswith("_locked") else 0
        for stmt in m.body:
            col.visit(stmt)
        collected.append((m, col))

    guarded: set[str] = set()
    for m, col in collected:
        if m.name == "__init__":
            continue
        for attr, _node, is_write, held in col.accesses:
            if is_write and held:
                guarded.add(attr)
    if not guarded:
        return

    for m, col in collected:
        if m.name == "__init__":
            continue
        seen: set[str] = set()
        for attr, node, _is_write, held in col.accesses:
            if held or attr not in guarded or attr in seen:
                continue
            if file.suppressed(node.lineno, "lock-ok"):
                seen.add(attr)
                continue
            seen.add(attr)
            lock = sorted(lock_attrs)[0]
            yield Finding(
                rule=f"{RULE}/unguarded-access", path=file.path,
                line=node.lineno, col=node.col_offset,
                message=f"{cls.name}.{m.name} accesses `self.{attr}` "
                        f"without holding `self.{lock}`, but `{attr}` is "
                        "written under the lock elsewhere in the class "
                        "(torn-read race; suppress a proven-safe access "
                        "with `# greenlint: lock-ok`)",
            )
