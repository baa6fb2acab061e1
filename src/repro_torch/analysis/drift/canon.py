"""greendrift AST canonicalizer: alpha-renamed, np/jnp/torch-folded forms.

Port of ``repro/analysis/drift/canon.py``: the reference's rewrites, which
give every np/jnp expression the reference's canonical string, plus
``torch`` as a namespace root and the few torch spellings the port's
registered twin sites use (listed under "torch bridges" below).

Turns one python expression (an anchor of a registered twin, see
``drift/registry.py``) into a :class:`CNode` tree on which structural
equality IS the "these two implementations encode the same law" relation
the twin registry needs. The rewrites, in the order they apply while
recursing bottom-up:

  * namespace collapse — ``np.X`` / ``numpy.X`` / ``jnp.X`` /
    ``jax.numpy.X`` / ``torch.X`` all map to one ``NPCALL X`` node, so
    the batched tensor twins compare against their numpy host-side
    siblings;
  * value-transparent wrappers vanish — ``float(x)``, ``int(x)``,
    ``np.asarray(x, dtype)``, ``x.astype(d)``, ``dtype=`` keywords: all
    no-ops on the traced value, all dropped;
  * python/numpy spelling bridges — ``max(a, b)`` ≡ ``np.maximum(a, b)``,
    ``a if c else b`` ≡ ``np.where(c, a, b)``, ``and``/``&`` ≡ ``AND``,
    ``np.mod(a, b)`` ≡ ``a % b``, ``np.stack([...])`` ≡ the sequence,
    ``np.zeros((n,))`` ≡ ``np.zeros(n)``;
  * torch bridges — ``torch.clamp(x, min=a)`` ≡ ``np.maximum(x, a)``,
    ``max=`` ≡ ``np.minimum``, both (or two positional bounds) ≡
    ``np.clip``; ``x.float()`` / ``x.double()`` / ``x.to(dtype)`` vanish
    as ``astype`` does; a broadcast index (``x[:, None]``, ``x[None]``:
    only full slices, ``None`` and ``...``) vanishes, since every law
    here compares elementwise; ``torch.zeros_like(a)`` ≡ ``np.zeros(n)``
    (zeros of a's shape: the shape is one fresh variable, as ``n`` is);
  * constant folding — ``np.pi``, ``math.pi`` and friends become
    literals; pure-
    constant subtrees evaluate; the constant operands of a commutative
    chain combine (``2.0 * np.pi * x`` ≡ ``6.2831... * x``); ``1`` and
    ``1.0`` compare equal by value;
  * named-constant resolution — UPPER_CASE module constants with a known
    numeric value (the ``constants`` env built from the linted file set)
    fold to that value, so ``PROP_RTT_S_PER_MS * d`` in one module equals
    ``cm.PROP_RTT_BULK_S_PER_MS * d`` in another;
  * calibrated-field leaves keep their name — a leaf whose terminal
    attribute is a calibrated cost-law field (``CostModelParams`` /
    ``MemoryBudget``: ``params.beta``, ``self.params.beta``, bare
    ``beta``) canonicalizes to ``PARAM beta``,
    so swapping ``beta`` for ``gamma_c`` on one side is a divergence even
    though both are "just a variable";
  * alpha renaming — every other simple value reference (locals,
    ``self.slope``, ``util[lnk]``) becomes a positional ``VAR`` id, so
    twins with different local naming conventions still compare equal.
    Commutative operands are sorted by a name-insensitive shape key
    (which includes each variable's occurrence count, so reuse patterns
    survive reordering) BEFORE ids are assigned.

Inherent limits: this is alpha-equivalence plus arithmetic spelling, not
semantic equivalence — e.g. a guard rewritten from ``x / p`` to
``x / max(p, 1)`` is (correctly) a divergence, and non-trivially
rearranged algebra needs either a source-side cleanup or a line-scoped
``# greenlint: twin-ok <why>``. Axes are not compared: the broadcast
bridge drops every new axis, so a ``None`` placed on the wrong operand
(``slope * d[:, None]`` for ``slope[:, None] * d``) canonicalizes like
the right one. The numpy sides have no axis to compare it with (the
batched forms add the env axis the host forms lack), so this limit is
accepted: the shapes are held by the port's parity tests, which run each
batched form against its host form.
"""
from __future__ import annotations

import ast
import dataclasses
import math

# roots that mean "the array namespace" when they head an attribute chain
_NS_ROOTS = ("np", "numpy", "jnp", "torch")
# roots whose attributes are numeric constants only (``math.pi``)
_CONST_ROOTS = ("math",)

# namespace attributes that are numeric constants
_NS_CONSTS = {"pi": math.pi, "e": math.e, "inf": math.inf, "nan": math.nan}

# namespace callables that keep their name (and argument structure)
_NS_SAME = frozenset({
    "sum", "max", "min", "mean", "prod", "clip", "floor", "ceil", "round",
    "sin", "cos", "tan", "exp", "log", "sqrt", "maximum", "minimum", "abs",
    "arange", "zeros", "ones", "full", "full_like", "zeros_like",
    "ones_like", "sign", "tanh", "dot", "resize", "argsort", "argmax",
    "argmin", "flatnonzero", "concatenate", "cumsum", "broadcast_to",
})
# array methods that mirror namespace callables: x.sum() == np.sum(x)
_METHOD_SAME = frozenset({
    "sum", "max", "min", "mean", "prod", "clip", "argsort", "argmax",
    "argmin", "round",
})
_NS_COMMUTATIVE = frozenset({"maximum", "minimum"})
# namespace callables transparent to the value: np.asarray(x, dtype) -> x
_NS_TRANSPARENT = frozenset({
    "asarray", "array", "float32", "float64", "int32", "int64", "float_",
})
# namespace callables whose single sequence argument is the value
_NS_SEQ = frozenset({"stack", "hstack", "vstack"})
_SHAPE_CALLS = frozenset({"zeros", "ones", "full", "empty"})
# torch: shape-of-argument constructors -> the np constructor of a shape
_TORCH_LIKE = {"zeros_like": "zeros", "ones_like": "ones",
               "full_like": "full"}
# torch: bounded clamps -> np.maximum / np.minimum / np.clip
_TORCH_CLAMP = frozenset({"clamp", "clip"})
# tensor methods transparent to the value: x.float(), x.to(torch.float32)
_METHOD_CAST = frozenset({"float", "double"})

_BINOP = {
    ast.Sub: "SUB", ast.Div: "DIV", ast.Pow: "POW", ast.Mod: "MOD",
    ast.FloorDiv: "FLOORDIV", ast.MatMult: "MATMUL",
}
_COMMUTATIVE_BINOP = {
    ast.Add: "ADD", ast.Mult: "MUL", ast.BitAnd: "AND", ast.BitOr: "OR",
    ast.BitXor: "XOR",
}
_CMP = {
    ast.Eq: "==", ast.NotEq: "!=", ast.Lt: "<", ast.LtE: "<=",
    ast.Gt: ">", ast.GtE: ">=", ast.Is: "is", ast.IsNot: "is not",
    ast.In: "in", ast.NotIn: "not in",
}
# orient strict/loose comparisons one way so a >= b matches b <= a
_CMP_FLIP = {">": "<", ">=": "<="}
_CMP_COMMUTATIVE = frozenset({"==", "!="})

_FOLD = {
    "ADD": lambda a, b: a + b, "MUL": lambda a, b: a * b,
    "SUB": lambda a, b: a - b, "DIV": lambda a, b: a / b,
    "POW": lambda a, b: a ** b, "MOD": lambda a, b: a % b,
    "FLOORDIV": lambda a, b: a // b,
}


@dataclasses.dataclass
class CNode:
    """One canonical-form node; ``src`` points back at the source AST."""

    kind: str                      # CONST/PARAM/VAR/ADD/.../NPCALL/CALL/...
    label: object = None
    children: tuple = ()
    src: ast.AST | None = None
    var_key: str | None = None     # raw leaf key, VAR only (pre-alpha)
    alpha: int | None = None       # assigned after sorting

    def render(self) -> str:
        """Canonical serialization (equality surface)."""
        if self.kind == "VAR":
            return f"v{self.alpha}"
        head = self.kind if self.label is None else (
            f"{self.kind}:{self.label!r}"
        )
        if not self.children:
            return head
        return f"{head}({', '.join(c.render() for c in self.children)})"

    def pretty(self) -> str:
        """Human-oriented one-liner for finding messages."""
        return self.render()


def _shape_key(node: CNode, counts: dict[str, int]) -> tuple:
    """Name-insensitive sort key for commutative operand ordering.

    VAR leaves render as their whole-anchor occurrence count — so the
    repeated variable keeps its role (``a + a`` ≢ ``a + b``) while pure
    renamings reorder freely. Everything else sorts by kind/label/
    children shape.
    """
    if node.kind == "VAR":
        return ("VAR", counts.get(node.var_key, 0))
    return (
        node.kind, repr(node.label),
        tuple(_shape_key(c, counts) for c in node.children),
    )


class Canonicalizer:
    """Stateful single-anchor canonicalization (one instance per anchor)."""

    def __init__(
        self,
        param_names: frozenset[str] = frozenset(),
        constants: dict[str, float] | None = None,
    ):
        self.param_names = param_names
        self.constants = constants or {}

    # -------------------------------------------------------------- public
    def run(self, expr: ast.expr) -> CNode:
        root = self._c(expr)
        counts: dict[str, int] = {}
        self._count_vars(root, counts)
        self._sort(root, counts)
        self._assign_alpha(root, {})
        return root

    # ----------------------------------------------------------- finalize
    def _count_vars(self, node: CNode, counts: dict[str, int]) -> None:
        if node.kind == "VAR":
            counts[node.var_key] = counts.get(node.var_key, 0) + 1
        for c in node.children:
            self._count_vars(c, counts)

    def _sort(self, node: CNode, counts: dict[str, int]) -> None:
        for c in node.children:
            self._sort(c, counts)
        if node.kind in ("ADD", "MUL", "AND", "OR", "XOR") or (
            node.kind == "NPCALL" and node.label in _NS_COMMUTATIVE
        ) or (node.kind == "CMP" and node.label in _CMP_COMMUTATIVE):
            node.children = tuple(sorted(
                node.children, key=lambda c: _shape_key(c, counts)
            ))

    def _assign_alpha(self, node: CNode, ids: dict[str, int]) -> None:
        if node.kind == "VAR":
            if node.var_key not in ids:
                ids[node.var_key] = len(ids)
            node.alpha = ids[node.var_key]
        for c in node.children:
            self._assign_alpha(c, ids)

    # ------------------------------------------------------------ helpers
    def _dotted(self, node: ast.expr) -> str | None:
        """Textual form of a simple value reference, else None."""
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            base = self._dotted(node.value)
            return None if base is None else f"{base}.{node.attr}"
        if isinstance(node, ast.Subscript):
            base = self._dotted(node.value)
            idx = self._dotted(node.slice)
            if base is None or idx is None:
                return None
            return f"{base}[{idx}]"
        if isinstance(node, ast.Constant):
            return repr(node.value)
        return None

    def _ns_member(self, func: ast.expr) -> str | None:
        """`np.X` / `jnp.X` / `jax.numpy.X` / `torch.X` -> "X", else
        None."""
        if not isinstance(func, ast.Attribute):
            return None
        base = func.value
        if isinstance(base, ast.Name) and base.id in _NS_ROOTS:
            return func.attr
        if (
            isinstance(base, ast.Attribute)
            and isinstance(base.value, ast.Name)
            and base.value.id == "jax"
            and base.attr == "numpy"
        ):
            return func.attr
        return None

    @staticmethod
    def _is_torch(func: ast.expr) -> bool:
        return (isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "torch")

    @staticmethod
    def _is_broadcast_index(sl: ast.expr) -> bool:
        """``[:, None]``, ``[None]``, ``[..., None]``: full slices, ``...``
        and at least one ``None`` (a new axis) — no element selected."""
        elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        new_axis = False
        for e in elts:
            if isinstance(e, ast.Constant) and e.value is None:
                new_axis = True
            elif isinstance(e, ast.Constant) and e.value is Ellipsis:
                continue
            elif not (isinstance(e, ast.Slice) and e.lower is None
                      and e.upper is None and e.step is None):
                return False
        return new_axis

    def _const(self, value, src) -> CNode:
        if isinstance(value, bool):
            return CNode("CONST", value, src=src)
        if isinstance(value, (int, float)):
            return CNode("CONST", float(value), src=src)
        return CNode("CONST", value, src=src)

    def _leaf(self, node: ast.expr, dotted: str) -> CNode:
        terminal = dotted.split("[")[0].rsplit(".", 1)[-1]
        if "[" not in dotted:
            if terminal in self.constants and terminal.isupper():
                return self._const(self.constants[terminal], node)
            if terminal in self.param_names:
                return CNode("PARAM", terminal, src=node)
        return CNode("VAR", src=node, var_key=dotted)

    # --------------------------------------------------------------- core
    def _c(self, node: ast.expr) -> CNode:
        if isinstance(node, ast.Constant):
            return self._const(node.value, node)

        # namespace constants: np.pi, jnp.inf, math.pi, ...
        member = self._ns_member(node) if isinstance(node, ast.Attribute) \
            else None
        if (
            member is None and isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id in _CONST_ROOTS
        ):
            member = node.attr
        if member is not None and member in _NS_CONSTS:
            return self._const(_NS_CONSTS[member], node)

        # a broadcast index adds axes only: the law is elementwise
        if isinstance(node, ast.Subscript) and self._is_broadcast_index(
            node.slice
        ):
            return self._c(node.value)

        dotted = self._dotted(node)
        if dotted is not None:
            return self._leaf(node, dotted)

        if isinstance(node, ast.BinOp):
            return self._binop(node)
        if isinstance(node, ast.BoolOp):
            kind = "AND" if isinstance(node.op, ast.And) else "OR"
            out = CNode(kind, src=node,
                        children=tuple(self._c(v) for v in node.values))
            return self._flatten(out)
        if isinstance(node, ast.UnaryOp):
            child = self._c(node.operand)
            if isinstance(node.op, ast.USub):
                if child.kind == "CONST" and isinstance(
                    child.label, (int, float)
                ):
                    return self._const(-child.label, node)
                return CNode("NEG", children=(child,), src=node)
            if isinstance(node.op, ast.Not):
                return CNode("NOT", children=(child,), src=node)
            if isinstance(node.op, ast.UAdd):
                return child
            return CNode("INVERT", children=(child,), src=node)
        if isinstance(node, ast.Compare):
            return self._compare(node)
        if isinstance(node, ast.IfExp):
            return CNode("WHERE", src=node, children=(
                self._c(node.test), self._c(node.body), self._c(node.orelse)
            ))
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, (ast.Tuple, ast.List)):
            return CNode("SEQ", src=node,
                         children=tuple(self._c(e) for e in node.elts))
        if isinstance(node, ast.Subscript):
            return CNode("IDX", src=node, children=(
                self._c(node.value), self._c(node.slice)
            ))
        if isinstance(node, ast.Attribute):
            return CNode("ATTR", node.attr, src=node,
                         children=(self._c(node.value),))
        # anything else (lambdas, comprehensions, ...) compares by dump
        return CNode("RAW", ast.dump(node), src=node)

    def _flatten(self, node: CNode) -> CNode:
        """Flatten nested commutative chains and combine their constants."""
        if node.kind not in ("ADD", "MUL", "AND", "OR"):
            return node
        flat: list[CNode] = []
        for c in node.children:
            if c.kind == node.kind:
                flat.extend(c.children)
            else:
                flat.append(c)
        if node.kind in ("ADD", "MUL"):
            consts = [c for c in flat if c.kind == "CONST"
                      and isinstance(c.label, float)]
            if len(consts) >= 2:
                value = consts[0].label
                for c in consts[1:]:
                    value = _FOLD[node.kind](value, c.label)
                flat = [c for c in flat if c not in consts]
                flat.append(self._const(value, node.src))
            # identity elements vanish: x * 1.0 == x, y + 0.0 == y
            identity = 0.0 if node.kind == "ADD" else 1.0
            keep = [c for c in flat
                    if not (c.kind == "CONST" and c.label == identity)]
            if keep:
                flat = keep
        if len(flat) == 1:
            return flat[0]
        node.children = tuple(flat)
        return node

    def _binop(self, node: ast.BinOp) -> CNode:
        left, right = self._c(node.left), self._c(node.right)
        op_t = type(node.op)
        kind = _COMMUTATIVE_BINOP.get(op_t) or _BINOP.get(op_t)
        if kind is None:
            return CNode("RAW", ast.dump(node), src=node)
        if (
            left.kind == "CONST" and right.kind == "CONST"
            and isinstance(left.label, float)
            and isinstance(right.label, float)
            and kind in _FOLD
        ):
            try:
                return self._const(_FOLD[kind](left.label, right.label), node)
            except (ZeroDivisionError, OverflowError):
                pass
        out = CNode(kind, src=node, children=(left, right))
        return self._flatten(out)

    def _compare(self, node: ast.Compare) -> CNode:
        if len(node.ops) != 1:  # chained comparisons compare structurally
            return CNode("RAW", ast.dump(node), src=node)
        op = _CMP.get(type(node.ops[0]), "?")
        left, right = self._c(node.left), self._c(node.comparators[0])
        if op in _CMP_FLIP:
            op = _CMP_FLIP[op]
            left, right = right, left
        return CNode("CMP", op, src=node, children=(left, right))

    def _call(self, node: ast.Call) -> CNode:
        func = node.func
        kwargs = [k for k in node.keywords
                  if k.arg is not None and k.arg != "dtype"]

        # builtins bridging to the array namespace
        if isinstance(func, ast.Name):
            name, n_args = func.id, len(node.args)
            if name in ("float", "int") and n_args == 1 and not kwargs:
                return self._c(node.args[0])
            if name in ("max", "min") and n_args >= 2 and not kwargs:
                mapped = "maximum" if name == "max" else "minimum"
                return CNode(
                    "NPCALL", mapped, src=node,
                    children=tuple(self._c(a) for a in node.args),
                )
            if name == "abs" and n_args == 1:
                return CNode("NPCALL", "abs", src=node,
                             children=(self._c(node.args[0]),))

        member = self._ns_member(func)
        if member is not None and self._is_torch(func):
            bridged = self._torch_call(node, member, kwargs)
            if bridged is not None:
                return bridged
        if member is not None:
            if member in _NS_TRANSPARENT and node.args:
                return self._c(node.args[0])
            if member in _NS_SEQ and len(node.args) == 1:
                return self._c(node.args[0])
            if member == "where" and len(node.args) == 3:
                return CNode("WHERE", src=node, children=tuple(
                    self._c(a) for a in node.args
                ))
            if member == "mod" and len(node.args) == 2:
                return CNode("MOD", src=node, children=(
                    self._c(node.args[0]), self._c(node.args[1])
                ))
            if member == "power" and len(node.args) == 2:
                return CNode("POW", src=node, children=(
                    self._c(node.args[0]), self._c(node.args[1])
                ))
            args = list(node.args)
            if (
                member in _SHAPE_CALLS and args
                and isinstance(args[0], ast.Tuple)
                and len(args[0].elts) == 1
            ):
                args[0] = args[0].elts[0]
            children = [self._c(a) for a in args]
            children += [
                CNode("KW", k.arg, children=(self._c(k.value),), src=node)
                for k in sorted(kwargs, key=lambda k: k.arg)
            ]
            # every namespace member lands here — unmapped ones keep their
            # name, so an np-call the table doesn't know still compares
            # (and mismatches) structurally instead of vanishing
            return CNode("NPCALL", member, src=node, children=tuple(children))

        # value-transparent / namespace-bridging methods
        if isinstance(func, ast.Attribute):
            if func.attr == "astype" and len(node.args) <= 1 and not kwargs:
                return self._c(func.value)
            if func.attr in _METHOD_CAST and not node.args and not kwargs:
                return self._c(func.value)
            if func.attr == "to" and len(node.args) <= 1 and not kwargs:
                return self._c(func.value)
            if func.attr in _METHOD_SAME and not node.args and not kwargs:
                return CNode("NPCALL", func.attr, src=node,
                             children=(self._c(func.value),))

        # ordinary call: identity is the terminal callee name
        if isinstance(func, ast.Attribute):
            callee = func.attr
        elif isinstance(func, ast.Name):
            callee = func.id
        else:
            callee = ast.dump(func)
        children = [self._c(a) for a in node.args]
        children += [
            CNode("KW", k.arg, children=(self._c(k.value),), src=node)
            for k in sorted(kwargs, key=lambda k: k.arg)
        ]
        return CNode("CALL", callee, src=node, children=tuple(children))

    def _torch_call(self, node: ast.Call, member: str, kwargs
                    ) -> CNode | None:
        """The torch spellings with an np twin of another name or
        signature; None leaves the call to the shared namespace rules."""
        if member in _TORCH_CLAMP and node.args:
            kw = {k.arg: k.value for k in kwargs}
            if set(kw) - {"min", "max"} or len(node.args) > 3:
                return None
            lo = node.args[1] if len(node.args) > 1 else kw.get("min")
            hi = node.args[2] if len(node.args) > 2 else kw.get("max")
            x = self._c(node.args[0])
            if lo is not None and hi is not None:
                return CNode("NPCALL", "clip", src=node, children=(
                    x, self._c(lo), self._c(hi)))
            if lo is not None:
                return CNode("NPCALL", "maximum", src=node,
                             children=(x, self._c(lo)))
            if hi is not None:
                return CNode("NPCALL", "minimum", src=node,
                             children=(x, self._c(hi)))
            return None
        if member in _TORCH_LIKE and node.args and not kwargs:
            arg = node.args[0]
            key = self._dotted(arg) or ast.dump(arg)
            shape = CNode("VAR", src=arg, var_key=f"shape({key})")
            return CNode("NPCALL", _TORCH_LIKE[member], src=node, children=(
                shape, *(self._c(a) for a in node.args[1:])))
        return None


def canonicalize(
    expr: ast.expr,
    param_names: frozenset[str] = frozenset(),
    constants: dict[str, float] | None = None,
) -> CNode:
    """Canonical form of one anchor expression (see module docstring)."""
    return Canonicalizer(param_names, constants).run(expr)
