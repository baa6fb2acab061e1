"""The port's greendrift (``repro_torch.analysis.drift``): canonicalizer,
twin registry, mutation tests on the port's own twin sites, repo gate.

  * canonicalizer parity — every np/jnp case of the reference's
    canonicalizer tests (``tests/test_drift.py``) renders to the same
    canonical string under the reference's and the port's
    canonicalizers;
  * torch bridges — each absorbs its spelling, and none absorbs the
    divergences the reference's tests name (a changed coefficient, a
    swapped calibrated field, an added guard);
  * mutation tests — copies of the port's real twin sites, edited on one
    side, give exactly the expected finding;
  * the repo gate — every registered site resolves, the 35 twins are the
    reference's, every ``dynamic`` twin has a runner, and
    ``scripts/check_determinism_torch.py twins`` passes in-process.
"""
import ast
import importlib.util
import pathlib
import textwrap

import pytest

from repro.analysis.drift import registry as ref_registry
from repro.analysis.drift.canon import canonicalize as ref_canonicalize
from repro_torch.analysis import drift, engine
from repro_torch.analysis.drift import registry
from repro_torch.analysis.drift.canon import canonicalize
from repro_torch.analysis.drift.compare import diff

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _expr(src: str) -> ast.expr:
    return ast.parse(textwrap.dedent(src), mode="eval").body


def canon(src: str, params=(), consts=None) -> str:
    return canonicalize(_expr(src), frozenset(params), consts or {}).render()


# ===========================================================================
# canonicalizer parity with the reference
# ===========================================================================

P_BF = ("beta", "feature_bytes")
P_BG = ("beta", "gamma_c")
# (source, calibrated-field names, named constants): every np/jnp case
# of the reference's canonicalizer tests, plus its spelling bridges
NP_CASES = [
    ("(1.0 - u) / (1.0 + slope * d)", (), None),
    ("(1.0 - util) / (1.0 + rate_slope * delay)", (), None),
    ("params.beta * rows * params.feature_bytes", P_BF, None),
    ("params.feature_bytes * params.beta * rows", P_BF, None),
    ("a * b + a", (), None),
    ("q * p + p", (), None),
    ("x + x", (), None),
    ("x + y", (), None),
    ("np.maximum(x, 1.0)", (), None),
    ("jnp.maximum(x, 1.0)", (), None),
    ("np.clip(v, 0.0, 1.0)", (), None),
    ("jnp.clip(w, 0.0, 1.0)", (), None),
    ("max(float(p), 1.0)", (), None),
    ("jnp.maximum(p, 1.0)", (), None),
    ("a if c else b", (), None),
    ("np.where(c, a, b)", (), None),
    ("2.0 * np.pi * x", (), None),
    ("x * 6.283185307179586", (), None),
    ("RTT * d", (), {"RTT": 2e-3}),
    ("0.002 * d", (), None),
    ("x * 1.0 + 0.0", (), None),
    ("x", (), None),
    ("np.asarray(w, np.float32) / total", (), None),
    ("w / total", (), None),
    ("1.0 + 2.0 * over", (), None),
    ("1.0 + 3.0 * over", (), None),
    ("params.beta * x", P_BG, None),
    ("params.gamma_c * x", P_BG, None),
    ("x / p", (), None),
    ("x / max(p, 1.0)", (), None),
    ("a >= b", (), None),
    ("b <= a", (), None),
    ("(1.0 - u) / (1.0 + s * d)", (), None),
    ("(1.0 - u) / (1.0 + d)", (), None),
    ("np.zeros((n,))", (), None),
    ("np.zeros(n)", (), None),
    ("np.zeros_like(a) + x", (), None),
    ("np.stack([a, b])", (), None),
    ("np.mod(a, b)", (), None),
    ("np.power(a, b) + abs(c)", (), None),
    ("x.astype(np.float64).sum()", (), None),
    ("jax.numpy.floor(x) % 2", (), None),
    ("(step >= onset) and (step < onset + duration)", (), None),
]


@pytest.mark.parametrize("src,params,consts", NP_CASES,
                         ids=[c[0] for c in NP_CASES])
def test_canonical_string_equals_the_references(src, params, consts):
    want = ref_canonicalize(_expr(src), frozenset(params),
                            consts or {}).render()
    assert canon(src, params, consts) == want


def test_reference_equalities_hold():
    assert canon("(1.0 - u) / (1.0 + slope * d)") == \
        canon("(1.0 - util) / (1.0 + rate_slope * delay)")
    assert canon("a * b + a") == canon("q * p + p")
    assert canon("x + x") != canon("x + y")
    assert canon("2.0 * np.pi * x") == canon("x * 6.283185307179586")
    assert canon("1.0 + 2.0 * over") != canon("1.0 + 3.0 * over")
    assert canon("params.beta * x", P_BG) != canon("params.gamma_c * x",
                                                   P_BG)
    assert canon("x / p") != canon("x / max(p, 1.0)")
    assert canon("a >= b") == canon("b <= a")


def test_diff_points_at_first_divergent_subtree():
    a = canonicalize(_expr("(1.0 - u) / (1.0 + s * d)"))
    b = canonicalize(_expr("(1.0 - u) / (1.0 + d)"))
    d = diff(a, b)
    assert d is not None
    assert "s * d" in d.describe()


# ===========================================================================
# torch bridges: each absorbs its spelling, none absorbs a divergence
# ===========================================================================

# (bridge, torch template, np template); {c} coefficient, {f} calibrated
# field, {d} denominator: the np side with d = max(p, 1.0) adds a guard
BRIDGES = [
    ("clamp-min", "torch.clamp({c} * params.{f} * x / {d}, min=0.5)",
     "np.maximum({c} * params.{f} * x / {d}, 0.5)"),
    ("clamp-max", "torch.clamp({c} * params.{f} * x / {d}, max=0.5)",
     "np.minimum({c} * params.{f} * x / {d}, 0.5)"),
    ("clamp-both", "torch.clamp({c} * params.{f} * x / {d}, min=0.0, "
                   "max=1.0)",
     "np.clip({c} * params.{f} * x / {d}, 0.0, 1.0)"),
    ("clamp-positional", "torch.clamp({c} * params.{f} * x / {d}, 0.0, 1.0)",
     "jnp.clip({c} * params.{f} * x / {d}, 0.0, 1.0)"),
    ("float", "({c} * params.{f} * x / {d}).float()",
     "{c} * params.{f} * x / {d}"),
    ("double", "({c} * params.{f} * x).double() / {d}",
     "float({c} * params.{f} * x) / {d}"),
    ("to", "({c} * params.{f} * x).to(torch.float32) / {d}",
     "np.asarray({c} * params.{f} * x, np.float32) / {d}"),
    ("math-pi", "{c} * math.pi * params.{f} * x / {d}",
     "{c} * np.pi * params.{f} * x / {d}"),
    ("broadcast-index", "{c} * params.{f}[:, None] * x[None] / {d}[..., None]",
     "{c} * params.{f} * x / {d}"),
    ("where", "torch.where((c0 == 0)[:, None], {c} * params.{f} * x / {d}, y)",
     "{c} * params.{f} * x / {d} if c0 == 0 else y"),
    ("stack", "torch.stack([{c} * params.{f} * x / {d}, y], dim=1)",
     "[{c} * params.{f} * x / {d}, y]"),
    ("floor", "torch.floor({c} * params.{f} * x / {d}) % 2",
     "np.floor({c} * params.{f} * x / {d}) % 2"),
    ("sin", "torch.sin({c} * params.{f} * x / {d})",
     "jnp.sin({c} * params.{f} * x / {d})"),
    ("zeros-like", "[torch.zeros_like(a), {c} * params.{f} * a / {d}]",
     "[np.zeros(n), {c} * params.{f} * a / {d}]"),
]
BASE = dict(c="2.0", f="beta", d="p")
VARIANTS = {
    "same": ({}, True),
    "changed-coefficient": ({"c": "3.0"}, False),
    "swapped-calibrated-field": ({"f": "gamma_c"}, False),
    "added-guard": ({"d": "max(p, 1.0)"}, False),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name,torch_t,np_t", BRIDGES,
                         ids=[b[0] for b in BRIDGES])
def test_bridge(name, torch_t, np_t, variant):
    change, equal = VARIANTS[variant]
    left = canon(torch_t.format(**BASE), P_BG)
    right = canon(np_t.format(**{**BASE, **change}), P_BG)
    assert (left == right) is equal, (left, right)


@pytest.mark.parametrize("src", ["x[:, 0]", "x[1:, None]", "x[:, :-1]"])
def test_selecting_index_is_not_transparent(src):
    assert canon(src) != canon("x")


def test_broadcast_axis_is_not_compared():
    """The accepted limit (``canon.py``'s docstring): a new axis on the
    wrong operand reads as the right one; the parity tests hold shapes."""
    assert canon("slope * d[:, None]") == canon("slope[:, None] * d") \
        == canon("slope * d")


def test_zeros_like_keeps_the_reuse_pattern():
    """The shape is a fresh variable: it does not stand for ``a``."""
    assert canon("torch.zeros_like(a) + a") != canon("np.zeros(a) + a")
    assert canon("torch.zeros_like(a) + a") == canon("np.zeros(n) + a")


def test_clamp_without_a_bound_is_left_alone():
    assert canon("torch.clamp(x)") != canon("x")


# ===========================================================================
# mutation tests on copies of the port's twin sites
# ===========================================================================

@pytest.fixture(scope="module")
def port():
    files = engine.load_files()
    return files, engine.ProjectIndex.build(files)


def drift_after(port, path: str, edits) -> list:
    """Drift findings over the port with ``path``'s source edited."""
    files, index = port
    out = []
    for f in files:
        if f.path == path:
            text = f.text
            for old, new, count in edits:
                assert text.count(old) == count, old
                text = text.replace(old, new)
            f = engine.SourceFile.parse(path, text)
        out.append(f)
    return sorted(drift.check_project(out, index),
                  key=lambda x: (x.path, x.line, x.rule))


def test_unedited_port_is_drift_clean(port):
    assert drift_after(port, "core/queue_sim.py", []) == []


# (case, file, [(old, new, occurrences)], rule, where it is reported,
#  twin or helper named)
MUTATIONS = [
    ("peer-mw-field", "kernels/cluster_window/ref.py",
     [("peer_mw = params.beta * peer_miss_rows",
       "peer_mw = params.gamma_c * peer_miss_rows", 1)],
     "drift/twin-divergence", "kernels/cluster_window/ref.py",
     "peer-miss-work"),
    ("service-law-coefficient", "kernels/cluster_window/ref.py",
     [("phi_base = (1.0 - util) / (1.0 + slope[:, None] * d)",
       "phi_base = (1.0 - util) / (1.0 + 2.0 * slope[:, None] * d)", 1)],
     "drift/twin-divergence", "kernels/cluster_window/ref.py",
     "service-law"),
    ("delta-osc-coefficient", "core/domain_rand.py",
     [("osc = 0.5 * (1.0 + np.sin(", "osc = 0.25 * (1.0 + np.sin(", 1)],
     "drift/twin-divergence", "core/domain_rand.py", "delta-osc"),
    ("paper-severity-tensor-form", "core/domain_rand.py",
     [("sev = (15.0 + 2.5 * phase.float())",
       "sev = (15.0 + 2.0 * phase.float())", 1)],
     "drift/twin-divergence", "core/domain_rand.py",
     "paper-schedule-severity"),
    ("collective-cpu-field", "envs/cluster_sim.py",
     [("cpu = phases * (per_phase + params.beta * chunk)",
       "cpu = phases * (per_phase + params.gamma_c * chunk)", 1)],
     "drift/twin-divergence", "envs/cluster_sim.py", "collective-cpu"),
    # the cluster env reaches mem_spill through queue_sim.window_operands
    ("window-operands-drops-mem-spill", "core/queue_sim.py",
     [("= mem_spill(", "= _spill_copy(", 2)],
     "drift/missing-shared-helper", "envs/cluster_sim.py", "mem_spill"),
    ("queue-window-drops-step-cost", "kernels/queue_window/ref.py",
     [("step_cost = qs.make_step_cost(", "step_cost = qs._step_copy(", 1)],
     "drift/missing-shared-helper", "kernels/queue_window/ref.py",
     "make_step_cost"),
    ("calibration-drops-compute-law", "core/calibration.py",
     [("t_base = float(compute_step_s(", "t_base = float(_law_copy(", 1)],
     "drift/missing-shared-helper", "core/calibration.py",
     "compute_step_s"),
    ("cluster-env-drops-summary", "envs/cluster_sim.py",
     [("out = qs.summarize_window(", "out = qs._summary_copy(", 1)],
     "drift/missing-shared-helper", "envs/cluster_sim.py",
     "summarize_window"),
    ("pasted-active-rows-scale", "kernels/cluster_window/ref.py",
     [("peer_miss_rows * qs.ACTIVE_ROWS_SCALE",
       "peer_miss_rows * 0.12", 1)],
     "drift/rehardcoded-constant", "kernels/cluster_window/ref.py",
     "ACTIVE_ROWS_SCALE"),
]


@pytest.mark.parametrize("path,edits,rule,at,named",
                         [m[1:] for m in MUTATIONS],
                         ids=[m[0] for m in MUTATIONS])
def test_one_sided_edit_is_exactly_one_finding(port, path, edits, rule, at,
                                               named):
    found = drift_after(port, path, edits)
    assert [(f.rule, f.path) for f in found] == [(rule, at)], \
        [str(f) for f in found]
    assert named in found[0].message


def test_env_that_stops_calling_window_operands_is_reported(port):
    """The cluster env reaches the volumes and the spill only through the
    intermediary its sites name: dropping that call (a window that
    inlines its own operands, spill included) breaks all three twins."""
    found = drift_after(port, "envs/cluster_sim.py", [(
        "h_o, vol, fabric = qs.window_operands(",
        "h_o, vol, fabric = _operands_with_inlined_spill(", 1)])
    assert [(f.rule, f.path) for f in found] == \
        [("drift/missing-shared-helper", "envs/cluster_sim.py")] * 3
    named = sorted(f.message.split("shared helper ")[1].split()[0]
                   for f in found)
    assert named == ["'action_volumes'", "'mem_spill'",
                     "'reference_volumes'"]


def test_intermediary_is_resolved_by_module_and_qualname(port):
    """Another function of the same bare name that calls ``mem_spill``
    does not stand in for ``queue_sim.window_operands``."""
    found = drift_after(port, "core/queue_sim.py", [
        ("= mem_spill(", "= _spill_copy(", 2),
        ("\ndef window_operands(",
         "\nclass _Elsewhere:\n"
         "    def window_operands(self, cfg, window):\n"
         "        return mem_spill(cfg, window)\n\n\n"
         "def window_operands(", 1)])
    assert [(f.rule, f.path) for f in found] == \
        [("drift/missing-shared-helper", "envs/cluster_sim.py")]
    assert "mem_spill" in found[0].message


def test_only_the_cluster_env_reaches_a_helper_through_an_intermediary():
    """Every other shared-helper caller keeps the reference's direct-call
    rule."""
    via = sorted((t.name, s.via.module, s.via.qualname)
                 for t in registry.TWINS for s in t.sites if s.via)
    assert via == [(name, "core/queue_sim.py", "window_operands")
                   for name in ("cluster-action-volumes",
                                "cluster-mem-spill",
                                "cluster-reference-volumes")]


def test_renamed_site_is_reported(port):
    found = drift_after(port, "envs/cluster_sim.py", [
        ("def ring_collective_t(", "def ring_collective_renamed(", 1),
        ("= ring_collective_t(", "= ring_collective_renamed(", 1)])
    assert {f.rule for f in found} == {"drift/missing-site"}
    assert len(found) == 5     # four law twins and the dynamic one


def test_twin_ok_with_rationale_suppresses(port):
    found = drift_after(port, "kernels/cluster_window/ref.py", [(
        "        peer_mw = params.beta * peer_miss_rows",
        "        # greenlint: twin-ok peers pay the congestion-slope rate\n"
        "        peer_mw = params.gamma_c * peer_miss_rows", 1)])
    assert found == []


# ===========================================================================
# repo gate
# ===========================================================================

def _load_check_determinism_torch():
    path = ROOT / "scripts" / "check_determinism_torch.py"
    spec = importlib.util.spec_from_file_location(
        "check_determinism_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_reference_twins_all_ported():
    """35 twins, the reference's names and kinds in the reference's
    order (none dropped, none turned dynamic)."""
    assert len(registry.TWINS) == len(ref_registry.TWINS) == 35
    assert [(t.name, t.kind) for t in registry.TWINS] == \
        [(t.name, t.kind) for t in ref_registry.TWINS]


def test_every_registered_site_resolves(port):
    files = {f.path: f for f in port[0]}
    for twin in registry.TWINS:
        sites = list(twin.sites) + ([twin.helper] if twin.helper else [])
        for site in sites:
            assert site.module in files, (twin.name, site.module)
            node = drift._resolve_qualname(files[site.module].tree,
                                           site.qualname)
            assert node is not None, (twin.name, site.qualname)


def test_registry_kinds_are_wellformed():
    for twin in registry.TWINS:
        assert twin.kind in ("law", "shared-helper", "dynamic"), twin
        if twin.kind == "law":
            assert len(twin.sites) >= 2, twin.name
            assert all(s.anchor for s in twin.sites), twin.name
        if twin.kind == "shared-helper":
            assert twin.helper is not None, twin.name


def test_every_dynamic_twin_has_a_runner_and_the_twins_target_passes(
        capsys):
    mod = _load_check_determinism_torch()
    assert set(mod._TWIN_RUNNERS) == {t.name for t in
                                      registry.dynamic_twins()}
    assert mod.main(["twins"]) == 0
    out = capsys.readouterr().out
    assert out.count("[twins] OK ") == 8 and "FAIL" not in out
