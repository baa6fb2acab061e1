"""greenlint rule registry.

Each rule module exposes ``check(file: SourceFile, index: ProjectIndex)
-> Iterator[Finding]`` plus a ``RULE`` family name; the engine runs every
registered rule over every file (rules self-scope by path). Rule docs
live in the modules, copies of the reference's rules with their codes
and messages unchanged.

The reference's ``jax_purity`` family is not ported: ``jax/*`` checks
code that JAX traces (the port has none; its ``float(...)`` on a tensor
is a host read, not a tracer coercion).
"""
from repro_torch.analysis.rules import (
    config_plumbing,
    determinism,
    excepts,
    locks,
    obs,
)

ALL_RULES = (determinism, locks, config_plumbing, excepts, obs)

__all__ = [
    "ALL_RULES",
    "config_plumbing",
    "determinism",
    "excepts",
    "locks",
    "obs",
]
