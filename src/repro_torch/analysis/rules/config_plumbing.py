"""Rule family ``config``: numeric knobs come from configs, not literals.

The seed bugs, both shipped and both silent for multiple PRs:

  * PR-5: ``domain_rand.sample_profile`` hard-coded its afflicted-link
    sampling range at ``[0, 3)`` — callers passed ``cfg.total_steps`` but
    not ``cfg.n_owners``, so at ``n_owners=7`` links 3-6 were never
    congested and at ``n_owners=1`` archetype deltas were silently zero.
  * PR-3: the Double-DQN target-sync gate was ``it % 100`` with the
    cadence also expressed as a config default — the literal drifted out
    of sync with the config's meaning (and counted the wrong thing).

Two checks, both scoped to functions that have a config in scope (a
parameter named ``cfg``/``config`` or annotated with a known
``*Config``/``*Params`` dataclass):

  * ``hard-coded-arg`` — a bare numeric literal passed to a
    project-defined function where the bound parameter name matches a
    field of an in-scope config class (positional binding uses the
    project signature table and only fires when every definition of that
    name agrees; keyword binding is direct);
  * ``hard-coded-modulus`` — ``x % N`` with an int literal ``N >= 2``
    where an in-scope config class has an int field whose default equals
    ``N`` (the ``it % 100`` shape: the cadence exists as config, the
    gate ignores it).

Suppress a genuinely-constant literal with ``# greenlint: literal-ok``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import Finding, ProjectIndex, SourceFile

RULE = "config"

_CONFIG_PARAM_NAMES = frozenset({"cfg", "config", "run_cfg", "env_cfg"})


def _dotted(node: ast.expr) -> tuple[str, ...]:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return tuple(reversed(parts))


def _annotation_name(ann: ast.expr | None) -> str | None:
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.rsplit(".", 1)[-1]
    d = _dotted(ann)
    return d[-1] if d else None


def _in_scope_config_fields(
    fn, index: ProjectIndex
) -> dict[str, tuple[dict[str, object], bool]]:
    """{param name: (field table, annotated)} for config parameters.

    An *annotated* parameter gives the exact field table of one config
    class; an unannotated ``cfg``/``config`` parameter is matched against
    the union of every known config's fields (call-arg check only — the
    modulus check would be too noisy against the union)."""
    out: dict[str, tuple[dict[str, object], bool]] = {}
    for a in (*fn.args.posonlyargs, *fn.args.args, *fn.args.kwonlyargs):
        ann = _annotation_name(a.annotation)
        if ann in index.config_fields:
            out[a.arg] = (index.config_fields[ann], True)
        elif a.arg in _CONFIG_PARAM_NAMES:
            merged: dict[str, object] = {}
            for fields in index.config_fields.values():
                merged.update(fields)
            out[a.arg] = (merged, False)
    return out


def _numeric_literal(node: ast.expr):
    """The numeric value of a bare (possibly negated) literal, else None."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    if isinstance(node, ast.Constant) and isinstance(
        node.value, (int, float)
    ) and not isinstance(node.value, bool):
        return node.value
    return None


def check(file: SourceFile, index: ProjectIndex) -> Iterator[Finding]:
    for node in ast.walk(file.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            configs = _in_scope_config_fields(node, index)
            if configs:
                yield from _check_function(file, node, index, configs)


def _check_function(file, fn, index: ProjectIndex, configs) -> Iterator[Finding]:
    field_names = frozenset(
        n for fields, _typed in configs.values() for n in fields
    )
    # modulus check: only exactly-typed configs (see _in_scope_config_fields)
    int_defaults: dict[int, list[str]] = {}
    for pname, (fields, typed) in configs.items():
        if not typed:
            continue
        for fname, default in fields.items():
            if isinstance(default, int) and default >= 2:
                int_defaults.setdefault(default, []).append(
                    f"{pname}.{fname}"
                )

    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            yield from _check_call(file, node, index, configs, field_names)
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
            lit = _numeric_literal(node.right)
            if (
                isinstance(lit, int)
                and lit in int_defaults
                and not file.suppressed(node.lineno, "literal-ok")
            ):
                sources = ", ".join(sorted(int_defaults[lit]))
                yield Finding(
                    rule=f"{RULE}/hard-coded-modulus", path=file.path,
                    line=node.lineno, col=node.col_offset,
                    message=f"hard-coded modulus `% {lit}` shadows a "
                            f"config field with that default ({sources}); "
                            "plumb the config value (the PR-3 `it % 100` "
                            "target-sync bug class). Suppress with "
                            "`# greenlint: literal-ok`",
                )


def _check_call(
    file, node: ast.Call, index: ProjectIndex, configs, field_names
) -> Iterator[Finding]:
    d = _dotted(node.func)
    callee = d[-1] if d else None
    if callee is None or callee in ("range", "min", "max", "round"):
        return
    # keyword bindings need no signature lookup
    bindings: list[tuple[str, ast.expr]] = []
    for kw in node.keywords:
        if kw.arg is not None:
            bindings.append((kw.arg, kw.value))
    # positional bindings only for project-defined callees whose
    # definitions agree on the parameter name
    if callee in index.signatures:
        for pos, arg in enumerate(node.args):
            pname = index.bind_positional(callee, pos)
            if pname is not None:
                bindings.append((pname, arg))

    for pname, arg in bindings:
        if pname not in field_names:
            continue
        lit = _numeric_literal(arg)
        if lit is None:
            continue
        if file.suppressed(arg.lineno, "literal-ok"):
            continue
        holders = sorted(
            p for p, (fields, _t) in configs.items() if pname in fields
        )
        yield Finding(
            rule=f"{RULE}/hard-coded-arg", path=file.path,
            line=arg.lineno, col=arg.col_offset,
            message=f"literal {lit!r} passed as `{pname}=` to "
                    f"`{callee}()` while `{holders[0]}.{pname}` is in "
                    "scope; plumb the config field (the PR-5 "
                    "`sample_profile` hard-coded owner-range bug class). "
                    "Suppress with `# greenlint: literal-ok`",
        )
