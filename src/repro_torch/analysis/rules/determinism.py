"""Rule family ``determinism``: simulation paths run on virtual time only.

The repo's headline guarantee is that same-seed runs are bit-identical:
the fabric, the cluster driver, and both pure-JAX env twins operate
exclusively on explicit virtual clocks and seeded generators. Anything
that reads the OS clock, draws from process-global RNG state, or branches
on the environment inside those modules silently breaks that guarantee —
usually in a way no test catches until a cross-machine repro diverges.

Scope: the sim-path modules (``core/``, ``net/``, ``envs/``, ``store/``,
``train/cluster.py``, ``train/worker.py``, and the port's plain window
loops ``kernels/queue_window/ref.py`` and ``kernels/cluster_window/ref.py``,
which run the envs' windows on the CPU). The legitimately wall-clock
modules (``pipeline/`` measures real rebuild overlap, ``launch/`` drives
real hardware) are simply out of scope; inside the sim paths an
exceptional measured-time site can carry ``# greenlint: measured-time``.

Checks:
  * ``wall-clock`` — ``time.time/perf_counter/monotonic/...``,
    ``datetime.now/utcnow/today`` calls;
  * ``global-rng`` — ``np.random.<fn>()`` module-level draws (the global
    legacy RNG), unseeded ``default_rng()``, and any use of the stdlib
    ``random`` module;
  * ``env-branch`` — ``os.environ`` / ``os.getenv`` appearing in the test
    of an ``if``/``while``/ternary (simulation behavior must not depend
    on ambient environment variables).
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import Finding, ProjectIndex, SourceFile

RULE = "determinism"

# modules whose behavior must be a pure function of (config, seed)
SIM_PATH_PREFIXES = ("core/", "net/", "envs/", "store/")
SIM_PATH_FILES = ("train/cluster.py", "train/worker.py",
                  "kernels/queue_window/ref.py",
                  "kernels/cluster_window/ref.py")

_WALL_CLOCK_TIME_FNS = frozenset({
    "time", "time_ns", "perf_counter", "perf_counter_ns",
    "monotonic", "monotonic_ns", "process_time", "process_time_ns",
})
_WALL_CLOCK_DATETIME_FNS = frozenset({"now", "utcnow", "today"})

# np.random attributes that are fine: explicit generator construction
_SEEDED_RNG_FACTORIES = frozenset({
    "default_rng", "Generator", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937",
})


def in_scope(path: str) -> bool:
    return path.startswith(SIM_PATH_PREFIXES) or path in SIM_PATH_FILES


def _dotted(node: ast.expr) -> tuple[str, ...]:
    """Trailing dotted-name parts of an attribute chain (best effort)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return tuple(reversed(parts))


def _mentions_environ(node: ast.expr) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == "environ":
            if _dotted(sub)[:1] == ("os",):
                return True
        if isinstance(sub, ast.Call):
            d = _dotted(sub.func)
            if d[-1:] == ("getenv",) and (len(d) == 1 or d[0] == "os"):
                return True
    return False


def check(file: SourceFile, index: ProjectIndex) -> Iterator[Finding]:
    if not in_scope(file.path):
        return
    has_stdlib_random = False
    np_aliases = {"np", "numpy"}
    for node in ast.walk(file.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "random" and alias.asname is None:
                    has_stdlib_random = True
        if isinstance(node, ast.ImportFrom) and node.module == "random":
            if not file.suppressed(node.lineno, "rng-ok"):
                yield Finding(
                    rule=f"{RULE}/global-rng", path=file.path,
                    line=node.lineno, col=node.col_offset,
                    message="stdlib `random` import in a simulation-path "
                            "module; thread RNG through seeded "
                            "np.random.Generator / jax.random keys",
                )

    for node in ast.walk(file.tree):
        if isinstance(node, ast.Call):
            yield from _check_call(file, node, has_stdlib_random, np_aliases)
        elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
            if _mentions_environ(node.test) and not file.suppressed(
                node.lineno, "env-ok"
            ):
                yield Finding(
                    rule=f"{RULE}/env-branch", path=file.path,
                    line=node.lineno, col=node.col_offset,
                    message="branch on os.environ/os.getenv in a "
                            "simulation-path module; plumb the knob "
                            "through a config field instead "
                            "(suppress: `# greenlint: env-ok`)",
                )


def _check_call(
    file: SourceFile, node: ast.Call, has_stdlib_random: bool,
    np_aliases: set,
) -> Iterator[Finding]:
    d = _dotted(node.func)
    if not d:
        return
    # ---- wall clock ----
    wall = (
        (len(d) == 2 and d[0] == "time" and d[1] in _WALL_CLOCK_TIME_FNS)
        or (len(d) >= 2 and d[-2] == "datetime"
            and d[-1] in _WALL_CLOCK_DATETIME_FNS)
    )
    if wall and not file.suppressed(node.lineno, "measured-time"):
        yield Finding(
            rule=f"{RULE}/wall-clock", path=file.path,
            line=node.lineno, col=node.col_offset,
            message=f"wall-clock read `{'.'.join(d)}()` in a "
                    "simulation-path module; simulation time must come "
                    "from the virtual clock (EnergyMeter.wall_s / "
                    "NetClock). If this site genuinely measures host "
                    "time, mark it `# greenlint: measured-time`",
        )
    # ---- global numpy RNG ----
    if len(d) >= 3 and d[-3] in np_aliases and d[-2] == "random":
        fn = d[-1]
        if fn not in _SEEDED_RNG_FACTORIES and not file.suppressed(
            node.lineno, "rng-ok"
        ):
            yield Finding(
                rule=f"{RULE}/global-rng", path=file.path,
                line=node.lineno, col=node.col_offset,
                message=f"global-state RNG draw `np.random.{fn}()`; use an "
                        "explicitly seeded np.random.default_rng(seed) / "
                        "SeedSequence stream",
            )
    # ---- unseeded default_rng() ----
    if d[-1] == "default_rng" and not node.args and not node.keywords:
        if not file.suppressed(node.lineno, "rng-ok"):
            yield Finding(
                rule=f"{RULE}/global-rng", path=file.path,
                line=node.lineno, col=node.col_offset,
                message="unseeded default_rng() (OS-entropy seeded) in a "
                        "simulation-path module; pass an explicit seed or "
                        "SeedSequence",
            )
    # ---- stdlib random module calls ----
    if (
        has_stdlib_random
        and len(d) == 2
        and d[0] == "random"
        and not file.suppressed(node.lineno, "rng-ok")
    ):
        yield Finding(
            rule=f"{RULE}/global-rng", path=file.path,
            line=node.lineno, col=node.col_offset,
            message=f"stdlib `random.{d[1]}()` draws from process-global "
                    "state; use seeded np.random.Generator / jax.random",
        )
