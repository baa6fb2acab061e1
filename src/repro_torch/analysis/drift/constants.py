"""greendrift calibrated-constant provenance pass.

Two checks, generalizing the PR-5 ``sample_profile(..., 3)`` bug class —
a calibrated value copied out of its named home and silently orphaned
from later re-calibration:

``drift/rehardcoded-constant``
    Index every UPPER_CASE module-level numeric constant in the sim
    paths (``PROP_RTT_BULK_S_PER_MS = 2e-3``, ``MAX_UTILIZATION = 0.95``,
    ``ACTIVE_ROWS_SCALE = 0.12``, ...). Any numeric literal elsewhere in
    a sim path that equals one of the DISTINCTIVE values (common numbers
    like 0/1/2/0.5 and round integers are exempt — matching those by
    value would be noise) is a finding: use the named constant, so a
    re-calibration edits one line instead of N.

``drift/constant-shadow-arg``
    Index every numeric field default of the ``*Config``/``*Params``
    dataclasses plus ``MemoryBudget``. A literal argument that BINDS
    (keyword, or positionally when every project definition of the
    callee agrees on the parameter name) to a parameter sharing a config
    field's name AND its default value is a finding even where no config
    object is in scope — that is value-shadowing: the call keeps working
    until the day the field's default moves and this site silently
    doesn't. (The config-plumbing family already covers the case where a
    config IS in scope.)

Both checks honor line-scoped ``# greenlint: twin-ok <why>`` and the
config-literal marker ``# greenlint: literal-ok <why>``.
"""
from __future__ import annotations

import ast
from collections.abc import Iterator

from repro_torch.analysis.engine import Finding, ProjectIndex, SourceFile

# sim paths: everywhere a calibrated value can silently fork. Slightly
# wider than the determinism rule's set — the trainer closed forms and
# the collective law carry calibrated constants too — and, in the port,
# the plain window loops the envs run (the CUDA kernels' references)
SIM_PATH_PREFIXES = ("core/", "net/", "envs/", "store/", "distributed/")
SIM_PATH_FILES = (
    "train/cluster.py", "train/worker.py", "train/gnn_trainer.py",
    "kernels/queue_window/ref.py", "kernels/cluster_window/ref.py",
)

# values too common to claim provenance over by equality alone
_COMMON = frozenset({
    0.0, 1.0, -1.0, 2.0, -2.0, 0.5, -0.5, 0.25, 0.75, 1.5, 0.1, 0.01,
    0.001, 1e-6, 1e-9, 1e-12, 10.0, 100.0, 1000.0,
})

# dataclasses indexed for field defaults beyond the *Config/*Params
# naming convention the engine's ProjectIndex already covers
EXTRA_CONFIG_CLASSES = ("MemoryBudget",)


def in_sim_path(path: str) -> bool:
    return path.startswith(SIM_PATH_PREFIXES) or path in SIM_PATH_FILES


def _sig_digits(value: float) -> int:
    """Significant decimal digits of the mantissa (0.95 -> 2, 0.6 -> 1)."""
    text = repr(abs(value))
    mantissa = text.split("e")[0].replace(".", "").strip("0")
    return len(mantissa)


def _distinctive(value: float) -> bool:
    """Worth claiming by value. Excluded: common numbers, round integers
    (window sizes, batch sizes, epoch counts all collide) and one-digit
    fractions like 0.6 / 0.03 (Nelder-Mead seeds, probability knobs).
    Kept: multi-digit calibrated values (0.95, 0.12, 4.67e-3, 2.01e-10)
    and anything below 1e-2 in magnitude (2e-3, 0.5e-3)."""
    if value in _COMMON or value != value or value == 0.0:  # NaN / zero
        return False
    if value == int(value) and -4096 <= value <= 4096:
        return False
    return _sig_digits(value) >= 2 or abs(value) < 1e-2


def _numeric(node: ast.expr):
    """Float value of a (possibly negated) numeric literal, else None."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _numeric(node.operand)
        return None if inner is None else -inner
    if isinstance(node, ast.Constant) and isinstance(
        node.value, (int, float)
    ) and not isinstance(node.value, bool):
        return float(node.value)
    return None


def module_constants(files: list[SourceFile]) -> dict[str, float]:
    """UPPER_CASE module-level numeric constants by name, across files.

    Alias assignments (``MAX_UTILIZATION = cm.MAX_UTILIZATION``) resolve
    through the terminal name, so a hoisted constant keeps one value no
    matter how many modules re-export it. Names bound to conflicting
    values anywhere are dropped as ambiguous.
    """
    values: dict[str, float] = {}
    conflicted: set[str] = set()
    aliases: list[tuple[str, str]] = []
    for f in files:
        for stmt in f.tree.body:
            if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
                continue
            target = stmt.targets[0]
            if not isinstance(target, ast.Name) or not target.id.isupper():
                continue
            v = _numeric(stmt.value)
            if v is not None:
                if target.id in values and values[target.id] != v:
                    conflicted.add(target.id)
                values[target.id] = v
                continue
            ref = stmt.value
            if isinstance(ref, (ast.Name, ast.Attribute)):
                terminal = ref.attr if isinstance(ref, ast.Attribute) \
                    else ref.id
                if terminal.isupper():
                    aliases.append((target.id, terminal))
    for _ in range(3):  # aliases may chain across files in any order
        for name, terminal in aliases:
            if terminal in values:
                if name in values and values[name] != values[terminal]:
                    conflicted.add(name)
                values[name] = values[terminal]
    return {k: v for k, v in values.items() if k not in conflicted}


def config_defaults(files: list[SourceFile], index: ProjectIndex
                    ) -> dict[str, float]:
    """field name -> numeric default, over *Config/*Params + the extras.

    Fields whose name maps to different defaults across classes are
    dropped (can't claim provenance for an ambiguous value).
    """
    fields: dict[str, float] = {}
    conflicted: set[str] = set()

    def _add(name: str, default) -> None:
        if not isinstance(default, (int, float)) or isinstance(
            default, bool
        ):
            return
        v = float(default)
        if name in fields and fields[name] != v:
            conflicted.add(name)
        fields[name] = v

    for cls_fields in index.config_fields.values():
        for name, default in cls_fields.items():
            _add(name, default)
    for f in files:
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.ClassDef) or (
                node.name not in EXTRA_CONFIG_CLASSES
            ):
                continue
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    v = _numeric(stmt.value) if stmt.value is not None \
                        else None
                    if v is not None:
                        _add(stmt.target.id, v)
    return {k: v for k, v in fields.items() if k not in conflicted}


def _definition_lines(tree: ast.Module) -> set[int]:
    """Lines that DEFINE constants (exempt from the re-hardcode check):
    module-level UPPER assigns and dataclass field defaults."""
    lines: set[int] = set()

    def _mark(node: ast.AST) -> None:
        for sub in ast.walk(node):
            if hasattr(sub, "lineno"):
                lines.add(sub.lineno)

    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name) and \
                stmt.targets[0].id.isupper():
            _mark(stmt)
        if isinstance(stmt, ast.AnnAssign) and isinstance(
            stmt.target, ast.Name
        ) and stmt.target.id.isupper():
            _mark(stmt)
        if isinstance(stmt, ast.ClassDef):
            for sub in stmt.body:
                if isinstance(sub, ast.AnnAssign):
                    _mark(sub)
    return lines


def _suppressed(file: SourceFile, line: int) -> bool:
    return file.suppressed(line, "twin-ok") or file.suppressed(
        line, "literal-ok"
    )


def check_rehardcoded(
    file: SourceFile, named: dict[str, float]
) -> Iterator[Finding]:
    if not in_sim_path(file.path):
        return
    by_value: dict[float, list[str]] = {}
    for name, v in named.items():
        if _distinctive(v):
            by_value.setdefault(v, []).append(name)
    if not by_value:
        return
    exempt = _definition_lines(file.tree)
    for node in ast.walk(file.tree):
        if not isinstance(node, ast.Constant):
            continue
        if isinstance(node.value, bool) or not isinstance(
            node.value, (int, float)
        ):
            continue
        v = float(node.value)
        names = by_value.get(v)
        if not names or node.lineno in exempt:
            continue
        if _suppressed(file, node.lineno):
            continue
        origin = " / ".join(sorted(names))
        yield Finding(
            rule="drift/rehardcoded-constant", path=file.path,
            line=node.lineno, col=node.col_offset,
            message=f"literal {node.value!r} re-hardcodes the named "
                    f"constant {origin}; reference it instead so a "
                    "re-calibration edits one definition",
        )


def check_shadow_args(
    file: SourceFile, index: ProjectIndex, defaults: dict[str, float]
) -> Iterator[Finding]:
    if not in_sim_path(file.path):
        return
    exempt = _definition_lines(file.tree)
    for node in ast.walk(file.tree):
        if not isinstance(node, ast.Call):
            continue
        bound: list[tuple[ast.expr, str]] = []
        for pos, arg in enumerate(node.args):
            name = None
            if isinstance(node.func, ast.Name):
                name = index.bind_positional(node.func.id, pos)
            elif isinstance(node.func, ast.Attribute):
                name = index.bind_positional(node.func.attr, pos)
            if name is not None:
                bound.append((arg, name))
        for kw in node.keywords:
            if kw.arg is not None:
                bound.append((kw.value, kw.arg))
        for arg, name in bound:
            v = _numeric(arg)
            if v is None or abs(v) < 2.0:
                continue
            default = defaults.get(name)
            if default is None or default != v:
                continue
            line = getattr(arg, "lineno", node.lineno)
            if line in exempt or _suppressed(file, line):
                continue
            yield Finding(
                rule="drift/constant-shadow-arg", path=file.path,
                line=line, col=getattr(arg, "col_offset", 0),
                message=f"literal {v!r} passed as {name!r} shadows the "
                        f"config field of the same name and default; pass "
                        "the plumbed field (the PR-5 hardcoded "
                        "n_owners bug class)",
            )


def check_file(
    file: SourceFile,
    index: ProjectIndex,
    named: dict[str, float],
    defaults: dict[str, float],
) -> Iterator[Finding]:
    yield from check_rehardcoded(file, named)
    yield from check_shadow_args(file, index, defaults)
