"""The port's invariant linter (``repro_torch.analysis``): engine, rule
families, CLI and baseline, held against the reference's engine.

Every fixture snippet of the five ported rule families (the reference's
``tests/test_analysis.py`` and ``tests/test_obs.py``, one case each, the
repeats merged) goes through both ``repro.analysis.engine.lint_sources``
and ``repro_torch.analysis.engine.lint_sources``: the two must report
the same ``(rule, path, line)`` set, and that set must be the one the
reference's test expects. The port's own gate follows: zero findings
over ``src/repro_torch`` against the empty committed baseline.
"""
import json
import pathlib
import textwrap

import pytest

from repro.analysis import engine as ref_engine
from repro_torch.analysis import engine
from repro_torch.analysis import rules
from repro_torch.analysis.__main__ import main as cli_main

PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"

DET_BAD = """
    import random
    import time
    import numpy as np

    def advance(sim):
        t0 = time.perf_counter()
        sim.t = time.time()
        jitter = np.random.rand()
        extra = random.random()
        rng = np.random.default_rng()
        return t0, jitter, extra, rng
"""

LOCKS_BAD = """
    import threading

    class Meter:
        def __init__(self):
            self._lock = threading.Lock()
            self.total = 0.0

        def add(self, x):
            with self._lock:
                self.total += x

        @property
        def snapshot(self):
            return self.total
"""

OBS_HEAD = """
    class W:
        def __init__(self, meter, tracer):
            self.meter = meter
            self.tracer = tracer
"""

# (case id, {path: source}, the rule set the reference's test expects)
CASES = [
    # ---- determinism ----
    ("det-known-bad", {"core/bad_sim.py": DET_BAD},
     {"determinism/wall-clock", "determinism/global-rng"}),
    ("det-env-branch", {"net/bad_env.py": """
        import os

        def rate(base):
            if os.environ.get("FAST_MODE"):
                return base * 2
            return base if not os.getenv("SLOW") else base / 2
    """}, {"determinism/env-branch"}),
    ("det-pipeline-out-of-scope", {"pipeline/measured.py": DET_BAD}, set()),
    ("det-launch-out-of-scope", {"launch/hw.py": DET_BAD}, set()),
    ("det-markers-suppress", {"core/marked.py": """
        import numpy as np
        import time

        def profile(sim):
            t0 = time.perf_counter()  # greenlint: measured-time host probe
            rng = np.random.default_rng()  # greenlint: rng-ok demo entropy
            return t0, rng
    """}, set()),
    ("det-seeded-fine", {"core/good_sim.py": """
        import numpy as np

        def advance(seed):
            rng = np.random.default_rng(seed)
            seq = np.random.SeedSequence(seed)
            return rng.normal(), seq
    """}, set()),
    # ---- locks ----
    ("locks-known-bad", {"net/bad_meter.py": LOCKS_BAD},
     {"locks/unguarded-access"}),
    ("locks-known-good", {"net/good_meter.py": """
        import threading

        class Meter:
            def __init__(self):
                self._lock = threading.Lock()
                self.total = 0.0

            def add(self, x):
                with self._lock:
                    self.total += x

            @property
            def snapshot(self):
                with self._lock:
                    return self.total
    """}, set()),
    ("locks-locked-suffix", {"net/split_meter.py": """
        import threading

        class Meter:
            def __init__(self):
                self._lock = threading.Lock()
                self.total = 0.0

            def add(self, x):
                with self._lock:
                    self._add_locked(x)

            def _add_locked(self, x):
                self.total += x
    """}, set()),
    ("locks-wait-for-lambda", {"train/cluster.py": """
        import threading

        class Gate:
            def __init__(self):
                self.cv = threading.Condition()
                self.step = 0

            def advance(self):
                with self.cv:
                    self.step += 1
                    self.cv.notify_all()

            def await_step(self, g):
                with self.cv:
                    self.cv.wait_for(lambda: self.step >= g)
    """}, set()),
    ("locks-nested-def", {"net/nested.py": """
        import threading

        class Meter:
            def __init__(self):
                self._lock = threading.Lock()
                self.total = 0.0

            def add(self, x):
                with self._lock:
                    self.total += x

                    def raced():
                        return self.total
                    return raced
    """}, {"locks/unguarded-access"}),
    ("locks-lock-ok", {"net/marked_meter.py": """
        import threading

        class Meter:
            def __init__(self):
                self._lock = threading.Lock()
                self.total = 0.0

            def add(self, x):
                with self._lock:
                    self.total += x

            @property
            def snapshot(self):
                return self.total  # greenlint: lock-ok atomic int read
    """}, set()),
    # ---- config ----
    ("config-pr5-sample-profile", {"core/randcfg.py": """
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class RandConfig:
            total_steps: int = 256
            n_owners: int = 3

        def sample_profile(key, total_steps, n_owners=3):
            return key, total_steps, n_owners

        def build(cfg: RandConfig, key):
            return sample_profile(key, cfg.total_steps, 3)
    """}, {"config/hard-coded-arg", "drift/constant-shadow-arg"}),
    ("config-keyword-literal", {"train/build.py": """
        import dataclasses

        @dataclasses.dataclass
        class RunConfig:
            batch_size: int = 600

        def sample(batch_size):
            return batch_size

        def run(cfg: RunConfig):
            return sample(batch_size=512)
    """}, {"config/hard-coded-arg"}),
    ("config-pr3-modulus", {"core/dqn.py": """
        import dataclasses

        @dataclasses.dataclass
        class DQNConfig:
            target_sync: int = 100

        def train_step(cfg: DQNConfig, it, params, target):
            if it % 100 == 0:
                target = params
            return target
    """}, {"config/hard-coded-modulus"}),
    ("config-plumbed", {"core/dqn.py": """
        import dataclasses

        @dataclasses.dataclass
        class DQNConfig:
            target_sync: int = 100

        def train_step(cfg: DQNConfig, it, params, target):
            if it % cfg.target_sync == 0:
                target = params
            return target
    """}, set()),
    ("config-literal-ok", {"core/randcfg.py": """
        import dataclasses

        @dataclasses.dataclass
        class RandConfig:
            n_owners: int = 3

        def sample_profile(key, n_owners=3):
            return key, n_owners

        def build(cfg: RandConfig, key):
            return sample_profile(key, 3)  # greenlint: literal-ok fixture arity
    """}, set()),
    ("config-no-config-in-scope", {"core/free.py": """
        def sample_profile(key, n_owners=3):
            return key, n_owners

        def build(key):
            return sample_profile(key, 3)
    """}, set()),
    # ---- excepts ----
    ("excepts-blanket-and-bare", {"train/bad.py": """
        def load(path):
            try:
                return open(path)
            except Exception:
                return None

        def probe(path):
            try:
                return open(path)
            except:
                return None
    """}, {"excepts/broad-except"}),
    ("excepts-broad-in-tuple", {"train/tup.py": """
        def load(path):
            try:
                return open(path)
            except (ValueError, Exception):
                return None
    """}, {"excepts/broad-except"}),
    ("excepts-reraise-and-narrow", {"train/ok.py": """
        def load(path):
            try:
                return open(path)
            except Exception:
                log(path)
                raise

        def probe(path):
            try:
                return open(path)
            except (OSError, ValueError):
                return None
    """}, set()),
    ("excepts-launch-exempt", {"launch/main.py": """
        def main():
            try:
                run()
            except Exception:
                return 1
    """}, set()),
    ("excepts-thread-boundary-marker", {"pipeline/ticketed.py": """
        def loop(work):
            for ticket, fn in work:
                try:
                    ticket.result = fn()
                except BaseException as e:  # greenlint: broad-except ticket relays it
                    ticket.error = e
    """}, set()),
    # ---- obs ----
    ("obs-unpaired", {"train/foo.py": OBS_HEAD + """
        def step(self, s):
            self.meter.record_step(s)
    """}, {"obs/meter-untraced"}),
    ("obs-paired", {"train/foo.py": OBS_HEAD + """
        def step(self, s):
            if self.tracer.enabled:
                self.tracer.charge_step(0.0, s, step=0, epoch=0)
            self.meter.record_step(s)
    """}, set()),
    ("obs-helper-indirection", {"train/foo.py": OBS_HEAD + """
        def _trace_step(self, s):
            self.tracer.charge_step(0.0, s, step=0, epoch=0)

        def step(self, s):
            if self.tracer.enabled:
                self._trace_step(s)
            self.meter.record_step(s)
    """}, set()),
    ("obs-untraced-module", {"bench/foo.py": """
        class Bench:
            def __init__(self, meter):
                self.meter = meter

            def run(self, s):
                self.meter.record_step(s)
    """}, set()),
    ("obs-ok-marker", {"train/foo.py": OBS_HEAD + """
        def warmup(self, s):
            # greenlint: obs-ok warmup joules charged by caller
            self.meter.record_step(s)
    """}, set()),
    # ---- engine: markers ----
    ("engine-unknown-marker", {"core/typo.py": """
        import time

        def f():
            return time.time()  # greenlint: measured-tiem
    """}, {"engine/unknown-marker", "determinism/wall-clock"}),
    ("engine-marker-rationale", {"core/why.py": """
        import time

        def f():
            # greenlint: measured-time calibration probe, host wall
            return time.time()
    """}, set()),
    ("engine-marker-atop-comment-block", {"core/blocky.py": """
        import time

        def f():
            # greenlint: measured-time — this helper genuinely
            # measures the host clock for the calibration probe
            # (three comment lines between marker and code)
            return time.time()
    """}, set()),
    ("engine-multiple-markers", {"core/multi.py": """
        import time
        import numpy as np

        def f():
            # greenlint: measured-time, rng-ok host-side demo
            return time.time() + np.random.default_rng().normal()
    """}, set()),
    ("engine-bare-marker", {"core/bare.py": """
        import time

        def f():
            return time.time()  # greenlint: measured-time
    """}, {"engine/bare-marker"}),
    ("engine-host-fn-known", {"envs/cluster_sim.py": """
        import numpy as np

        # greenlint: host-fn setup-time pool builder
        def build_pool(cfg):
            return np.asarray(cfg.pool)
    """}, set()),
    # ---- drift constants pass (the tests of tests/test_drift.py) ----
    ("drift-rehardcoded-constant", {
        "core/queue_sim.py": """
            PROP_RTT_S_PER_MS = 2e-3

            def wall(cpu, delta):
                return cpu + PROP_RTT_S_PER_MS * delta
        """,
        "core/table_sim.py": """
            def wall(cpu, delta):
                return cpu + 2e-3 * delta
        """}, {"drift/rehardcoded-constant"}),
    ("drift-common-values", {"core/knobs.py": """
        BIAS = 0.6
        HALF = 0.5
        WINDOW = 16.0

        def f(x):
            return 0.6 * x + 0.5 + 16.0
    """}, set()),
    ("drift-shadow-arg", {
        "core/randcfg.py": """
            import dataclasses

            @dataclasses.dataclass(frozen=True)
            class RandConfig:
                n_owners: int = 3

            def sample_profile(key, n_owners=3):
                return key, n_owners
        """,
        "core/launchlet.py": """
            from repro_torch.core.randcfg import sample_profile

            def build(key):
                return sample_profile(key, 3)
        """}, {"drift/constant-shadow-arg"}),
    ("drift-shadow-arg-other-value", {"core/randcfg.py": """
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class RandConfig:
            n_owners: int = 3

        def sample_profile(key, n_owners=3):
            return key, n_owners

        def build(key):
            return sample_profile(key, 7)
    """}, set()),
]


def _keys(findings) -> set:
    return {(f.rule, f.path, f.line) for f in findings}


@pytest.mark.parametrize("sources,expected", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_engine_parity_on_reference_fixtures(sources, expected):
    """Both engines give the same findings on every fixture, and the
    port's are the ones the reference's test expects. The reference's
    engine also runs its ``jax`` family, which the port does not port:
    its findings are left out of the comparison."""
    src = {p: textwrap.dedent(s) for p, s in sources.items()}
    ref = {k for k in _keys(ref_engine.lint_sources(src))
           if not k[0].startswith("jax/")}
    port = _keys(engine.lint_sources(src))
    assert port == ref
    assert {k[0] for k in port} == expected


def test_wall_clock_flagged_per_site():
    found = engine.lint_sources({"core/bad_sim.py": textwrap.dedent(DET_BAD)})
    assert len([f for f in found if f.rule == "determinism/wall-clock"]) == 2


@pytest.mark.parametrize("path", ["kernels/queue_window/ref.py",
                                  "kernels/cluster_window/ref.py"])
def test_plain_window_loops_are_sim_paths(path):
    """The port's plain window loops run the envs' windows: a wall-clock
    read or a pasted calibrated constant there is a finding."""
    found = engine.lint_sources({
        "core/knobs.py": "ACTIVE_ROWS_SCALE = 0.12\n",
        path: "import time\n\ndef loop(x):\n"
              "    return time.time() + 0.12 * x\n",
    })
    assert {(f.rule, f.path) for f in found} == {
        ("determinism/wall-clock", path),
        ("drift/rehardcoded-constant", path)}


def test_the_jax_family_is_not_ported():
    assert {r.RULE for r in rules.ALL_RULES} == {
        "determinism", "locks", "config", "excepts", "obs"}
    assert not hasattr(rules, "jax_purity")


def test_every_marker_of_the_ports_sources_is_known():
    """broad-except, literal-ok, lock-ok and host-fn (the reference's jax
    family's, on a config helper) are all known markers."""
    seen = set()
    for f in engine.load_files():
        for names in f.markers.values():
            seen |= names
    assert {"broad-except", "literal-ok", "lock-ok", "host-fn"} <= seen
    assert seen <= engine.KNOWN_MARKERS


# ------------------------------------------------------------ engine
def test_default_root_is_the_port():
    assert pathlib.Path(engine.package_root()) == PORT
    paths = {f.path for f in engine.load_files()}
    assert "envs/cluster_sim.py" in paths
    assert "analysis/engine.py" in paths


def test_fingerprint_is_line_independent():
    a = engine.Finding("r/x", "p.py", 10, 0, "msg")
    b = engine.Finding("r/x", "p.py", 99, 4, "msg")
    assert a.fingerprint() == b.fingerprint()
    assert a.fingerprint() != engine.Finding(
        "r/x", "p.py", 10, 0, "other").fingerprint()
    ref = ref_engine.Finding("r/x", "p.py", 10, 0, "msg")
    assert a.fingerprint() == ref.fingerprint()
    assert a.to_dict() == ref.to_dict()


def test_baseline_roundtrip_and_split(tmp_path):
    f1 = engine.Finding("r/x", "a.py", 1, 0, "one")
    f2 = engine.Finding("r/y", "b.py", 2, 0, "two")
    path = str(tmp_path / "baseline.json")
    engine.save_baseline([f1], path)
    baseline = engine.load_baseline(path)
    new, old = engine.split_baseline([f1, f2], baseline)
    assert [f.message for f in new] == ["two"]
    assert [f.message for f in old] == ["one"]


def test_shipped_baseline_is_empty():
    assert pathlib.Path(engine.default_baseline_path()) == \
        PORT / "analysis" / "baseline.json"
    assert engine.load_baseline() == frozenset()
    assert json.loads(
        (PORT / "analysis" / "baseline.json").read_text()
    ) == {"suppressions": []}


# --------------------------------------------------------------- CLI
def test_check_exits_zero_on_the_port(capsys):
    """The gate: every family, drift included, at zero findings over
    ``src/repro_torch`` against the empty baseline."""
    assert cli_main(["--check"]) == 0
    assert "[greenlint] 0 finding(s), 0 baseline-suppressed" in \
        capsys.readouterr().out


def test_check_exits_one_on_bad_tree_and_baseline_covers_it(tmp_path,
                                                           capsys):
    bad = tmp_path / "core"
    bad.mkdir()
    (bad / "sim.py").write_text(
        "import time\n\ndef f():\n    return time.time()\n")
    assert cli_main([str(tmp_path), "--check"]) == 1
    assert "core/sim.py:4" in capsys.readouterr().out
    base = str(tmp_path / "baseline.json")
    assert cli_main([str(tmp_path), "--update-baseline",
                     "--baseline", base]) == 0
    assert cli_main([str(tmp_path), "--check", "--baseline", base]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s), 1 baseline-suppressed" in out


def test_usage_error_exits_two():
    with pytest.raises(SystemExit) as exc:
        cli_main(["--no-such-flag"])
    assert exc.value.code == 2


def test_json_report_written(tmp_path):
    bad = tmp_path / "tree" / "net"
    bad.mkdir(parents=True)
    (bad / "env.py").write_text(
        "import os\n\ndef f(b):\n"
        "    return b if not os.getenv('X') else 2 * b\n")
    out = tmp_path / "report.json"
    assert cli_main([str(tmp_path / "tree"), "--json", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["n_new"] == 1
    assert report["findings"][0]["rule"] == "determinism/env-branch"
    assert report["findings"][0]["path"] == "net/env.py"
