"""greendrift: twin-consistency checks over the registered pairings.

Port of ``repro/analysis/drift/__init__.py`` over the port's registry.

:func:`check_project` is the family driver ``engine.lint_files`` calls
once per lint run (the twins span files, so this is a project-level pass,
not a per-file rule). It resolves every :class:`~.registry.Twin` against
the linted file set and dispatches on kind:

``law``          anchors canonicalized (``canon.py``) and structurally
                 compared (``compare.py``) against the first site;
``shared-helper`` the caller must still call the helper by name, or
                 call the one intermediary its site names in ``via``,
                 which must call the helper;
``dynamic``      both qualnames must still resolve (numerics live in
                 ``scripts/check_determinism_torch.py twins``).

Then the calibrated-constant provenance pass (``constants.py``) runs over
every sim-path file. Rules emitted here:

    drift/missing-site          registered qualname no longer resolves
    drift/missing-anchor        law anchor assignment/return disappeared
    drift/twin-divergence       canonical forms disagree (both spans shown)
    drift/missing-shared-helper caller re-inlined a private copy
    drift/rehardcoded-constant  named constant's value pasted as a literal
    drift/constant-shadow-arg   literal arg shadows a config field default

A twin engages only when EVERY module it references (all sites and their
``via`` intermediaries, plus the helper for shared-helper twins) is
present in the linted file set — true for any full-package run, so real
deletions are always caught, while
``lint_sources`` fixture runs on a handful of synthetic files do not
trip the repo twins that span modules the fixture doesn't provide.
Suppression: ``# greenlint: twin-ok <why>`` on either side's anchor line.
"""
from __future__ import annotations

import ast
import copy

from repro_torch.analysis.drift import compare, constants as const_pass
from repro_torch.analysis.drift.canon import canonicalize
from repro_torch.analysis.drift.registry import TWINS, Site, Twin, dynamic_twins
from repro_torch.analysis.engine import Finding, ProjectIndex, SourceFile

__all__ = [
    "TWINS", "Site", "Twin", "dynamic_twins", "check_project",
]

# classes whose field names classify as PARAM leaves for the law compare.
# Deliberately ONLY the calibrated cost-law containers: the point of a
# PARAM leaf is that swapping `beta` for `gamma_c` must be a divergence.
# Widening this to every *Config would turn incidental name collisions
# (locals that happen to share a topology field's name, like n_workers)
# into false divergences that alpha-renaming is meant to absorb.
_PARAM_CLASSES = ("CostModelParams",) + const_pass.EXTRA_CONFIG_CLASSES


def _resolve_qualname(tree: ast.Module, qualname: str):
    """Def/class node for a dotted qualname, walking nested scopes."""
    node: ast.AST = tree
    for part in qualname.split("."):
        found = None
        for sub in ast.walk(node):
            if sub is node:
                continue
            if isinstance(
                sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ) and sub.name == part:
                found = sub
                break
        if found is None:
            return None
        node = found
    return node


def _local_assignments(fn: ast.AST) -> dict[str, list[ast.expr]]:
    """name -> RHS list for simple single-target assigns in ``fn``'s own
    body (nested defs excluded — their locals are a different scope)."""
    out: dict[str, list[ast.expr]] = {}

    def _walk(stmts) -> None:
        for stmt in stmts:
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                out.setdefault(stmt.targets[0].id, []).append(stmt.value)
            elif isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name
            ) and stmt.value is not None:
                out.setdefault(stmt.target.id, []).append(stmt.value)
            for field in ("body", "orelse", "finalbody", "handlers"):
                for sub in getattr(stmt, field, ()):
                    if isinstance(sub, ast.stmt):
                        _walk([sub])
                    elif isinstance(sub, ast.ExceptHandler):
                        _walk(sub.body)

    _walk(getattr(fn, "body", []))
    return out


class _Inliner(ast.NodeTransformer):
    """Substitute single-assignment locals into an anchor expression."""

    def __init__(self, bindings: dict[str, ast.expr]):
        self.bindings = bindings

    def visit_Name(self, node: ast.Name):
        if isinstance(node.ctx, ast.Load) and node.id in self.bindings:
            return copy.deepcopy(self.bindings[node.id])
        return node


def _find_anchor(fn: ast.AST, site: Site) -> ast.expr | None:
    """First assignment RHS of the anchor name (or the first return value
    for anchor == "return"), inline-substituted per the site."""
    if site.anchor == "return":
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                expr = stmt.value
                break
        else:
            return None
    else:
        assigns = _local_assignments(fn)
        rhs = assigns.get(site.anchor or "")
        if not rhs:
            return None
        expr = rhs[0]
    if site.inline:
        assigns = _local_assignments(fn)
        bindings = {
            name: assigns[name][0]
            for name in site.inline
            if len(assigns.get(name, ())) == 1
        }
        expr = ast.fix_missing_locations(
            _Inliner(bindings).visit(copy.deepcopy(expr))
        )
    return expr


def _param_names(
    files: list[SourceFile], index: ProjectIndex
) -> frozenset[str]:
    names = {
        name
        for cls, fields in index.config_fields.items()
        if cls in _PARAM_CLASSES
        for name in fields
    }
    for f in files:
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ClassDef) and \
                    node.name in _PARAM_CLASSES:
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) and isinstance(
                        stmt.target, ast.Name
                    ):
                        names.add(stmt.target.id)
    return frozenset(names)


def _engaged(twin: Twin, files_by_path: dict[str, SourceFile]) -> bool:
    """A twin only engages when its FULL module set is in the linted file
    set — always true for a package run (so real deletions are caught),
    false for fixture runs that provide one synthetic file at a
    registered path without the twin's other side."""
    modules = {s.module for s in twin.sites}
    modules |= {s.via.module for s in twin.sites if s.via is not None}
    if twin.helper is not None:
        modules.add(twin.helper.module)
    return modules <= files_by_path.keys()


def _twin_suppressed(
    resolved: list[tuple[SourceFile, Site, ast.expr]]
) -> bool:
    for f, _site, expr in resolved:
        line = getattr(expr, "lineno", 0)
        if line and f.suppressed(line, "twin-ok"):
            return True
    return False


def _site_ref(f: SourceFile, expr: ast.expr) -> str:
    return f"{f.path}:{getattr(expr, 'lineno', 0)}"


def _check_law(
    twin: Twin,
    files_by_path: dict[str, SourceFile],
    param_names: frozenset[str],
    const_env: dict[str, float],
) -> list[Finding]:
    findings: list[Finding] = []
    resolved: list[tuple[SourceFile, Site, ast.expr]] = []
    if not _engaged(twin, files_by_path):
        return findings
    for site in twin.sites:
        f = files_by_path[site.module]
        fn = _resolve_qualname(f.tree, site.qualname)
        if fn is None:
            findings.append(Finding(
                rule="drift/missing-site", path=site.module, line=1, col=0,
                message=f"twin {twin.name!r}: registered qualname "
                        f"{site.qualname!r} no longer resolves; update the "
                        "registry or restore the implementation",
            ))
            continue
        expr = _find_anchor(fn, site)
        if expr is None:
            findings.append(Finding(
                rule="drift/missing-anchor", path=site.module,
                line=fn.lineno, col=fn.col_offset,
                message=f"twin {twin.name!r}: anchor {site.anchor!r} not "
                        f"found in {site.qualname}; the law fragment moved "
                        "or was renamed — update the registry",
            ))
            continue
        resolved.append((f, site, expr))
    if len(resolved) < 2 or _twin_suppressed(resolved):
        return findings
    ref_file, ref_site, ref_expr = resolved[0]
    ref_canon = canonicalize(ref_expr, param_names, const_env)
    for f, site, expr in resolved[1:]:
        side = canonicalize(expr, param_names, const_env)
        if side.render() == ref_canon.render():
            continue
        d = compare.diff(ref_canon, side)
        where = d.right if d else side
        line, col = compare.span(where) if d else (
            getattr(expr, "lineno", 0), getattr(expr, "col_offset", 0)
        )
        detail = d.describe() if d else "canonical forms differ"
        findings.append(Finding(
            rule="drift/twin-divergence", path=site.module,
            line=line or getattr(expr, "lineno", 0), col=col,
            message=(
                f"twin {twin.name!r}: {site.qualname}.{site.anchor} "
                f"diverges from the reference "
                f"{ref_site.qualname}.{ref_site.anchor} "
                f"({_site_ref(ref_file, ref_expr)}): {detail}"
            ),
        ))
    return findings


def _calls_in(fn: ast.AST) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute):
                out.add(func.attr)
            elif isinstance(func, ast.Name):
                out.add(func.id)
    return out


def _reaches(fn: ast.AST, helper_name: str, site: Site,
             files_by_path: dict[str, SourceFile]) -> bool:
    """``fn`` calls ``helper_name``; or, where the site names an
    intermediary in ``via``, calls it, and the intermediary (resolved by
    module and qualname) calls the helper."""
    calls = _calls_in(fn)
    if helper_name in calls:
        return True
    if site.via is None or \
            site.via.qualname.rsplit(".", 1)[-1] not in calls:
        return False
    via_fn = _resolve_qualname(files_by_path[site.via.module].tree,
                               site.via.qualname)
    return via_fn is not None and helper_name in _calls_in(via_fn)


def _check_shared_helper(
    twin: Twin, files_by_path: dict[str, SourceFile]
) -> list[Finding]:
    findings: list[Finding] = []
    helper = twin.helper
    assert helper is not None, twin.name
    if not _engaged(twin, files_by_path):
        return findings
    helper_file = files_by_path[helper.module]
    if _resolve_qualname(helper_file.tree, helper.qualname) is None:
        findings.append(Finding(
            rule="drift/missing-site", path=helper.module, line=1, col=0,
            message=f"twin {twin.name!r}: shared helper "
                    f"{helper.qualname!r} no longer exists in "
                    f"{helper.module}",
        ))
        return findings
    helper_name = helper.qualname.rsplit(".", 1)[-1]
    for site in twin.sites:
        f = files_by_path[site.module]
        fn = _resolve_qualname(f.tree, site.qualname)
        if fn is None:
            findings.append(Finding(
                rule="drift/missing-site", path=site.module, line=1, col=0,
                message=f"twin {twin.name!r}: registered caller "
                        f"{site.qualname!r} no longer resolves",
            ))
            continue
        if f.suppressed(fn.lineno, "twin-ok"):
            continue
        if not _reaches(fn, helper_name, site, files_by_path):
            findings.append(Finding(
                rule="drift/missing-shared-helper", path=site.module,
                line=fn.lineno, col=fn.col_offset,
                message=(
                    f"twin {twin.name!r}: {site.qualname} no longer calls "
                    f"the shared helper {helper_name!r} "
                    f"({helper.module}); a re-inlined private copy would "
                    "drift invisibly — call the helper"
                ),
            ))
    return findings


def _check_dynamic(
    twin: Twin, files_by_path: dict[str, SourceFile]
) -> list[Finding]:
    findings: list[Finding] = []
    if not _engaged(twin, files_by_path):
        return findings
    for site in twin.sites:
        f = files_by_path[site.module]
        if _resolve_qualname(f.tree, site.qualname) is None:
            findings.append(Finding(
                rule="drift/missing-site", path=site.module, line=1, col=0,
                message=f"twin {twin.name!r} (dynamic): qualname "
                        f"{site.qualname!r} no longer resolves; its numeric "
                        "runner in check_determinism_torch.py twins will "
                        "fail too",
            ))
    return findings


def check_project(
    files: list[SourceFile], index: ProjectIndex
) -> list[Finding]:
    """Run every drift analysis over the linted file set."""
    files_by_path = {f.path: f for f in files}
    const_env = const_pass.module_constants(files)
    param_names = _param_names(files, index)
    findings: list[Finding] = []
    for twin in TWINS:
        if twin.kind == "law":
            findings.extend(
                _check_law(twin, files_by_path, param_names, const_env)
            )
        elif twin.kind == "shared-helper":
            findings.extend(_check_shared_helper(twin, files_by_path))
        else:
            findings.extend(_check_dynamic(twin, files_by_path))
    defaults = const_pass.config_defaults(files, index)
    for f in files:
        findings.extend(
            const_pass.check_file(f, index, const_env, defaults)
        )
    return findings
