"""greenlint engine: file model, suppression pragmas, project index, driver.

Port of ``repro/analysis/engine.py``, over the port's own sources. Every
rule encodes an invariant the port's correctness rests on (bit-identical
same-seed runs, virtual-time-only simulation clocks, lock-guarded shared
state, config fields actually plumbed, twin laws that stay one law). The
engine keeps the mechanics shared:

  * :class:`SourceFile` — parsed AST + the ``# greenlint: <marker>``
    suppression comments of one file (line-scoped: trailing on the code
    line, or on a comment block directly above the statement; a free-text
    rationale may follow the marker name);
  * :class:`ProjectIndex` — cross-file facts rules need: dataclass
    ``*Config``/``*Params`` field tables (name -> default) and function
    signatures (bare name -> parameter names) for literal-binding;
  * :func:`run_analysis` / :func:`lint_sources` — drivers over a package
    tree or an in-memory ``{relpath: source}`` mapping (fixture tests);
  * baseline bookkeeping — a committed JSON list of finding fingerprints
    (line-number independent) that are tolerated; the gate fails on
    anything not in it. The shipped baseline is EMPTY: every violation the
    rules find in the port is fixed at the source.

Paths inside findings are POSIX-style and relative to the ``repro_torch``
package root (``core/queue_sim.py``), which is what the rule scoping
constants (sim-path modules, launch exemptions, twin sites) match
against. The reference's paths are the same, so a fixture snippet lints
alike under either engine.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import os
import re
import tokenize

MARKER_PREFIX = "greenlint:"

# markers a suppression comment may carry, mapped to the rule family they
# silence (documented in DESIGN.md "Invariants as code")
KNOWN_MARKERS = frozenset({
    "measured-time",   # determinism: legitimately wall-clock code
    "rng-ok",          # determinism: deliberate global/unseeded RNG
    "env-ok",          # determinism: deliberate os.environ branch
    "lock-ok",         # lock discipline: access proven safe another way
    "host-fn",         # jax purity (not ported: the port has no traced
                       # code); kept known so a marker the port's sources
                       # carry for the reference's engine is no finding
    "literal-ok",      # config plumbing: literal is genuinely not config
    "broad-except",    # excepts: thread-boundary handler that propagates
    "twin-ok",         # drift: registered twin intentionally diverges here
    "obs-ok",          # obs: meter call deliberately untraced (charged
                       # elsewhere); greentrace ledger unaffected
})


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str          # "<family>/<check>", e.g. "determinism/wall-clock"
    path: str          # posix path relative to the repro_torch root
    line: int
    col: int
    message: str

    def fingerprint(self) -> str:
        """Line-number-independent identity (baseline key)."""
        h = hashlib.sha256(self.message.encode()).hexdigest()[:12]
        return f"{self.rule}:{self.path}:{h}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "fingerprint": self.fingerprint(),
        }

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


_MARKER_NAME_RE = re.compile(r"^([a-z][a-z0-9-]*)\b\s*(.*)$")


def _parse_marker_names(rest: str) -> tuple[frozenset[str], bool]:
    """Marker names at the head of a pragma body, plus rationale presence.

    Grammar: ``marker[, marker ...] rationale`` — comma-separated
    kebab-case names followed by a MANDATORY free-text rationale (which
    may itself contain commas). Returns ``(names, has_rationale)``; a
    pragma without rationale still suppresses (so a missing rationale is
    one actionable finding, not a cascade of re-opened ones) but is
    reported by ``lint_files`` as ``engine/bare-marker``.
    """
    names = []
    has_rationale = False
    for piece in rest.split(","):
        m = _MARKER_NAME_RE.match(piece.strip())
        if m is None:
            break
        names.append(m.group(1))
        if m.group(2):  # rationale starts here; remaining pieces are prose
            has_rationale = True
            break
    return frozenset(names), has_rationale


def _collect_markers(
    text: str,
) -> tuple[dict[int, frozenset[str]], list[tuple[int, frozenset[str]]]]:
    """Map line number -> greenlint markers in effect on that line.

    A marker on a code line covers that line. A marker on a comment-only
    line also covers the first code line below the comment block, so a
    multi-line rationale comment still suppresses the statement under it.

    Also returns the pragmas that carry NO rationale text, as
    ``(pragma line, names)`` pairs — suppressing an invariant rule without
    saying why is itself a finding.
    """
    markers: dict[int, frozenset[str]] = {}
    bare: list[tuple[int, frozenset[str]]] = []
    lines = text.splitlines()

    def _stripped(ln: int) -> str:
        return lines[ln - 1].strip() if 1 <= ln <= len(lines) else ""

    try:
        tokens = tokenize.generate_tokens(io.StringIO(text).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            body = tok.string.lstrip("#").strip()
            if not body.startswith(MARKER_PREFIX):
                continue
            names, has_rationale = _parse_marker_names(
                body[len(MARKER_PREFIX):].strip()
            )
            if not has_rationale and names & KNOWN_MARKERS:
                bare.append((tok.start[0], names & KNOWN_MARKERS))
            at = [tok.start[0]]
            if _stripped(tok.start[0]).startswith("#"):
                ln = tok.start[0] + 1
                while _stripped(ln).startswith("#"):
                    ln += 1
                if ln <= len(lines):
                    at.append(ln)
            for ln in at:
                markers[ln] = markers.get(ln, frozenset()) | names
    except tokenize.TokenError:
        pass
    return markers, bare


@dataclasses.dataclass
class SourceFile:
    """One parsed module plus its suppression pragmas."""

    path: str                              # posix, repro_torch-relative
    text: str
    tree: ast.Module
    markers: dict[int, frozenset[str]]
    bare_markers: list[tuple[int, frozenset[str]]] = dataclasses.field(
        default_factory=list
    )

    @classmethod
    def parse(cls, path: str, text: str) -> "SourceFile":
        markers, bare = _collect_markers(text)
        return cls(
            path=path.replace(os.sep, "/"),
            text=text,
            tree=ast.parse(text, filename=path),
            markers=markers,
            bare_markers=bare,
        )

    def suppressed(self, line: int, marker: str) -> bool:
        """True if ``marker`` is declared on ``line`` or the line above."""
        for ln in (line, line - 1):
            if marker in self.markers.get(ln, ()):  # pragma: no branch
                return True
        return False

    def unknown_markers(self) -> list[tuple[int, str]]:
        out = []
        for line, names in sorted(self.markers.items()):
            for name in sorted(names - KNOWN_MARKERS):
                out.append((line, name))
        return out


# --------------------------------------------------------------------------
# Project index: cross-file facts for the config-plumbing rule
# --------------------------------------------------------------------------

_CONFIG_SUFFIXES = ("Config", "Params")


def _is_dataclass_decorator(dec: ast.expr) -> bool:
    node = dec.func if isinstance(dec, ast.Call) else dec
    name = node.attr if isinstance(node, ast.Attribute) else (
        node.id if isinstance(node, ast.Name) else ""
    )
    return name in ("dataclass", "register_dataclass")


@dataclasses.dataclass
class ProjectIndex:
    """Facts the rules need across module boundaries.

    ``config_fields``: dataclass name -> {field name: numeric default or
    None} for classes named ``*Config``/``*Params``.
    ``signatures``: bare function name -> list of parameter-name tuples
    (every definition sharing that name; used to bind positional literal
    arguments — a binding is trusted only when all definitions agree).
    """

    config_fields: dict[str, dict[str, object]] = dataclasses.field(
        default_factory=dict
    )
    signatures: dict[str, list[tuple[str, ...]]] = dataclasses.field(
        default_factory=dict
    )

    @classmethod
    def build(cls, files: list["SourceFile"]) -> "ProjectIndex":
        index = cls()
        for f in files:
            for node in ast.walk(f.tree):
                if isinstance(node, ast.ClassDef):
                    index._add_class(node)
                elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    index._add_function(node)
        return index

    def _add_class(self, node: ast.ClassDef) -> None:
        if not node.name.endswith(_CONFIG_SUFFIXES):
            return
        if not any(_is_dataclass_decorator(d) for d in node.decorator_list):
            return
        fields: dict[str, object] = {}
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name
            ):
                default = None
                if isinstance(stmt.value, ast.Constant) and isinstance(
                    stmt.value.value, (int, float)
                ) and not isinstance(stmt.value.value, bool):
                    default = stmt.value.value
                fields[stmt.target.id] = default
        if fields:
            self.config_fields.setdefault(node.name, {}).update(fields)

    def _add_function(self, node) -> None:
        params = tuple(
            a.arg
            for a in (*node.args.posonlyargs, *node.args.args)
            if a.arg not in ("self", "cls")
        )
        if params:
            self.signatures.setdefault(node.name, []).append(params)

    def all_config_field_names(self) -> frozenset[str]:
        return frozenset(
            name for f in self.config_fields.values() for name in f
        )

    def bind_positional(self, func_name: str, pos: int) -> str | None:
        """Parameter name literal argument #``pos`` binds to, if every
        project definition of ``func_name`` agrees on it."""
        sigs = self.signatures.get(func_name)
        if not sigs:
            return None
        names = {sig[pos] for sig in sigs if pos < len(sig)}
        if len(names) != 1:
            return None
        return names.pop()


# --------------------------------------------------------------------------
# Drivers
# --------------------------------------------------------------------------

def package_root() -> str:
    """Absolute path of the ``repro_torch`` package (the default lint
    root)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _iter_py_files(root: str):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames if d != "__pycache__" and not d.startswith(".")
        )
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def load_files(root: str | None = None) -> list[SourceFile]:
    root = os.path.abspath(root or package_root())
    files = []
    for path in _iter_py_files(root):
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        files.append(SourceFile.parse(os.path.relpath(path, root), text))
    return files


def lint_files(files: list[SourceFile]) -> list[Finding]:
    from repro_torch.analysis import rules as rules_pkg

    index = ProjectIndex.build(files)
    findings: list[Finding] = []
    for f in files:
        for line, name in f.unknown_markers():
            findings.append(Finding(
                rule="engine/unknown-marker", path=f.path, line=line, col=0,
                message=f"unknown greenlint marker {name!r}; known: "
                        f"{', '.join(sorted(KNOWN_MARKERS))}",
            ))
        for line, names in f.bare_markers:
            findings.append(Finding(
                rule="engine/bare-marker", path=f.path, line=line, col=0,
                message=f"suppression marker(s) {', '.join(sorted(names))} "
                        "without rationale; append free text explaining why "
                        "the invariant is safe to silence here",
            ))
        for rule in rules_pkg.ALL_RULES:
            findings.extend(rule.check(f, index))
    # the drift family is project-level: registered twin pairs span files,
    # so it runs over the whole file set rather than per file
    from repro_torch.analysis import drift as drift_pkg

    findings.extend(drift_pkg.check_project(files, index))
    findings.sort(key=lambda x: (x.path, x.line, x.col, x.rule))
    return findings


def run_analysis(root: str | None = None) -> list[Finding]:
    """Lint every .py file under ``root`` (default: the repro_torch
    package)."""
    return lint_files(load_files(root))


def lint_sources(sources: dict[str, str]) -> list[Finding]:
    """Lint an in-memory ``{package-relative path: source}`` mapping.

    This is the fixture-test entry point: known-bad snippets are linted
    exactly as if they lived at the given path inside ``repro_torch``.
    """
    files = [SourceFile.parse(p, t) for p, t in sources.items()]
    return lint_files(files)


# --------------------------------------------------------------------------
# Baseline
# --------------------------------------------------------------------------

def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def load_baseline(path: str | None = None) -> frozenset[str]:
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return frozenset()
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return frozenset(data.get("suppressions", []))


def save_baseline(findings: list[Finding], path: str | None = None) -> str:
    path = path or default_baseline_path()
    payload = {"suppressions": sorted(f.fingerprint() for f in findings)}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2)
        fh.write("\n")
    return path


def split_baseline(
    findings: list[Finding], baseline: frozenset[str]
) -> tuple[list[Finding], list[Finding]]:
    """-> (new findings, baseline-suppressed findings)."""
    new, old = [], []
    for f in findings:
        (old if f.fingerprint() in baseline else new).append(f)
    return new, old
