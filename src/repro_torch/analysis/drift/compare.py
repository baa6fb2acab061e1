"""greendrift structural differ: first divergent subtree of two CNodes.

``diff(a, b)`` walks two canonical trees (``drift/canon.py``) in lockstep
and returns the shallowest pair of nodes that disagree, or ``None`` when
the trees are equal. Finding messages then point at BOTH source spans via
the ``src`` back-references each CNode carries, so a twin divergence
reads as "this subtree here != that subtree there" instead of a bare
"functions differ".
"""
from __future__ import annotations

import ast
import dataclasses

from repro_torch.analysis.drift.canon import CNode


@dataclasses.dataclass(frozen=True)
class Divergence:
    """First structural disagreement between two canonical trees."""

    left: CNode
    right: CNode

    def describe(self) -> str:
        return f"{_excerpt(self.left)} != {_excerpt(self.right)}"


def _excerpt(node: CNode, limit: int = 60) -> str:
    """Source text of the divergent subtree (canonical form as fallback)."""
    src = node.src
    if isinstance(src, ast.AST):
        try:
            text = ast.unparse(src)
        except (ValueError, AttributeError, RecursionError):
            text = node.pretty()
    else:
        text = node.pretty()
    text = " ".join(text.split())
    return text if len(text) <= limit else text[: limit - 3] + "..."


def span(node: CNode) -> tuple[int, int]:
    """(line, col) of a canonical node's source anchor (0, 0 if unknown)."""
    src = node.src
    if isinstance(src, ast.AST) and hasattr(src, "lineno"):
        return src.lineno, getattr(src, "col_offset", 0)
    return 0, 0


def _node_eq(a: CNode, b: CNode) -> bool:
    if a.kind != b.kind or len(a.children) != len(b.children):
        return False
    if a.kind == "VAR":
        return a.alpha == b.alpha
    return a.label == b.label


def diff(a: CNode, b: CNode) -> Divergence | None:
    """Shallowest divergent pair, in deterministic left-to-right order."""
    if not _node_eq(a, b):
        return Divergence(a, b)
    for ca, cb in zip(a.children, b.children):
        d = diff(ca, cb)
        if d is not None:
            return d
    return None
