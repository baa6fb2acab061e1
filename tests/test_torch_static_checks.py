"""The reference's invariant linter (``repro.analysis``) over the port.

The port never imports ``repro``; this test runs the reference's
``run_analysis`` over ``src/repro_torch`` from outside it. The rule
families that apply to torch code are held at zero findings:
determinism, locks, excepts, obs and config, and the engine's own marker
checks. Two families are left out, as they do not apply: ``jax/*``
checks code that JAX traces (the port has none; its ``float(...)`` on a
tensor is a host read, not a tracer coercion), and ``drift/*`` holds the
twins its registry names, which are the reference's jnp functions at the
reference's qualnames (the port's batched tensor forms are held against
them by the ``test_torch_*`` parity tests instead).
"""
import pathlib

import pytest

from repro.analysis import engine

PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
HELD = ("determinism", "locks", "excepts", "obs", "config", "engine")
NOT_APPLICABLE = ("jax", "drift")


@pytest.fixture(scope="module")
def findings():
    return engine.run_analysis(str(PORT))


@pytest.mark.parametrize("family", HELD)
def test_no_findings_in_family(findings, family):
    hits = [f"{f.path}:{f.line}: [{f.rule}] {f.message}"
            for f in findings if f.rule.split("/")[0] == family]
    assert not hits, "\n".join(hits)


def test_every_family_is_held_or_stated(findings):
    """A finding of a family this test neither holds nor states as not
    applying fails, so a new rule family is not skipped unseen."""
    families = {f.rule.split("/")[0] for f in findings}
    assert families <= set(HELD) | set(NOT_APPLICABLE), families


def test_the_cluster_env_is_linted(findings):
    """The scan reaches the cluster env (its jax-family finding, on a
    config helper the reference marks ``host-fn``, is suppressed)."""
    files = {f.path for f in engine.load_files(str(PORT))}
    assert "envs/cluster_sim.py" in files
    assert "kernels/cluster_window/ref.py" in files
