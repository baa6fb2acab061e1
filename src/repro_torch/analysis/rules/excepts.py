"""Rule family ``excepts``: no silent swallowing of genuine bugs.

The seed bug: the corrupt-checkpoint fallback in ``train/policy.py``
caught blanket ``Exception`` around artifact loading — so a real bug
anywhere in the load path (shape mismatch from a refactor, a typo'd key)
silently fell through to a multi-minute retrain instead of surfacing.

Check ``broad-except``: a bare ``except:`` or an ``except`` clause
catching ``Exception``/``BaseException`` (alone or in a tuple) is flagged
unless one of:

  * the handler re-raises (a ``raise`` statement anywhere in its body) —
    cleanup-then-propagate handlers are the legitimate broad form;
  * the module lives under ``launch/`` — process entry points may map
    arbitrary failures to exit codes / user-facing messages;
  * the clause carries ``# greenlint: broad-except`` — thread-boundary
    handlers that ferry the exception object to another thread
    (CacheBuilder tickets, the cluster step gate) propagate without a
    literal ``raise``; the marker documents that contract.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import Finding, ProjectIndex, SourceFile

RULE = "excepts"

EXEMPT_PREFIXES = ("launch/",)
_BROAD = frozenset({"Exception", "BaseException"})


def _broad_name(type_node: ast.expr | None) -> str | None:
    if type_node is None:
        return "bare except"
    nodes = (
        type_node.elts if isinstance(type_node, ast.Tuple) else [type_node]
    )
    for n in nodes:
        name = n.attr if isinstance(n, ast.Attribute) else (
            n.id if isinstance(n, ast.Name) else None
        )
        if name in _BROAD:
            return name
    return None


def _reraises(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
    return False


def check(file: SourceFile, index: ProjectIndex) -> Iterator[Finding]:
    if file.path.startswith(EXEMPT_PREFIXES):
        return
    for node in ast.walk(file.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        broad = _broad_name(node.type)
        if broad is None:
            continue
        if _reraises(node):
            continue
        if file.suppressed(node.lineno, "broad-except"):
            continue
        yield Finding(
            rule=f"{RULE}/broad-except", path=file.path,
            line=node.lineno, col=node.col_offset,
            message=f"{broad} caught without re-raising: a genuine bug in "
                    "the try body is silently swallowed (the PR-2 "
                    "silent-retrain bug class); catch the specific "
                    "exceptions, re-raise, or mark a thread-boundary "
                    "handler `# greenlint: broad-except`",
        )
