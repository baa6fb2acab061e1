"""The port's cluster sweep (``repro_torch.paper.cluster_sweep``) against
the reference's ``benchmarks/cluster_sweep.py``, on the CPU.

Both command lines run twice on the same flags, ``reddit`` at batch 600
with ``--check``: at P = 2 and 3, the six scenarios (four emergent, two
injected) against all five methods and the mixture axis over 5 epochs
of 8 steps (the policies decide from step 16 on); then at P = 2 the
memory axis at the ``tight`` level over 3 epochs of 4 steps (its device
tier's gather is the reference's Pallas kernel, interpreted: at P = 3 it
alone took over a minute). Each package's ``get_or_train_policy`` is
replaced by one that records its call and returns one seeded qnet per
(env, owners, headroom), the same network on both sides (saved by the
reference, read by ``repro_torch.core.dqn``'s loader). The modeled lane is digest-equal across the packages, so the
printed tables and the written JSON (the rows, ``hot_share``,
``unlimited_parity``, ``deterministic`` and the tier counts) must be
equal byte for byte, and the policies asked for (names, envs, P,
headroom) equal. ``check_acceptance`` and ``check_mem_acceptance`` must
raise where the reference's raise, with its messages, on synthetic
result dicts that pass and that break each gate.
"""
import copy
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks import cluster_sweep as rsweep  # noqa: E402
from benchmarks import common as rcommon  # noqa: E402
from repro.core import controller as rctl  # noqa: E402
from repro.core import dqn as rdqn  # noqa: E402
from repro.train import policy as rpol  # noqa: E402
from repro_torch.core import dqn as pdqn  # noqa: E402
from repro_torch.paper import cluster_sweep as psweep  # noqa: E402
from repro_torch.train import policy as ppol  # noqa: E402
from _jax_release import release_jax_executables  # noqa: E402,F401

COMMON = ["--batch", "600", "--iterations", "10", "--check"]
FLAGS = {
    "axes": COMMON + ["--workers", "2,3", "--check-p", "3", "--steps", "40",
                      "--steps-per-epoch", "8", "--mixture"],
    "mem": COMMON + ["--workers", "2", "--check-p", "2", "--steps", "12",
                     "--steps-per-epoch", "4",
                     "--methods", "static_w,greendygnn",
                     "--mem-budget", "tight"],
}


class Policies:
    """A stand-in for both packages' ``get_or_train_policy``: one seeded
    qnet per (env, n_owners, headroom), the reference's jitted q_fn and
    the port's read from the same file; every call recorded."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.files = {}
        self.calls = {"ref": [], "port": []}

    def path(self, env, n_owners, headroom):
        key = (env, n_owners, headroom)
        if key not in self.files:
            net = rdqn.init_qnet(
                jax.random.PRNGKey(len(self.files) + 3),
                rctl.state_dim(n_owners, headroom), rctl.n_actions(n_owners))
            path = os.path.join(self.tmp, f"{env}_{n_owners}_{headroom}.npz")
            rdqn.save_qnet(path, net)
            self.files[key] = (path, net)
        return self.files[key]

    def fake(self, side):
        def get_or_train_policy(pool, name="qnet", iterations=40_000,
                                force=False, env=None, device="cuda",
                                **train_kw):
            n_owners = (train_kw["n_workers"] - 1 if env == "cluster"
                        else train_kw["n_owners"])
            headroom = bool((train_kw.get("cluster_kwargs") or {})
                            .get("observe_headroom"))
            self.calls[side].append(dict(
                name=name, iterations=iterations, force=force, env=env,
                **train_kw))
            path, net = self.path(env, n_owners, headroom)
            if side == "port":
                assert device == "cpu"
                qnet = pdqn.load_qnet(path)
                return pdqn.q_fn_of(qnet), qnet
            fwd = jax.jit(rdqn.q_forward)
            return (lambda s: np.asarray(fwd(net, jnp.asarray(
                s, jnp.float32)))), net
        return get_or_train_policy


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """{run: {side: (stdout lines, JSON text, (result, the message of
    the ``--check`` gate that failed))}} of both command lines on each
    of :data:`FLAGS`, and the recorded policy calls."""
    tmp = tmp_path_factory.mktemp("cluster_sweep")
    pols = Policies(str(tmp))
    mp = pytest.MonkeyPatch()
    mp.setattr(rpol, "get_or_train_policy", pols.fake("ref"))
    mp.setattr(ppol, "get_or_train_policy", pols.fake("port"))
    out = {}
    try:
        for run, flags in FLAGS.items():
            out[run] = {}
            for side, mod in (("ref", rsweep), ("port", psweep)):
                results = str(tmp / run / side)
                mp.setattr(mod, "RESULTS_DIR", results)
                if side == "ref":
                    mp.setattr(rcommon, "RESULTS_DIR", results)
                    mp.setattr(sys, "argv", ["cluster_sweep.py", *flags])
                    main = mod.main
                else:
                    def main(flags=flags):
                        return psweep.main([*flags, "--device", "cpu"])
                capture = _Capture()
                with capture:
                    result = _checked(main)
                with open(os.path.join(results, "cluster_sweep.json")) as f:
                    out[run][side] = (capture.lines(), f.read(), result)
    finally:
        mp.undo()
    yield out, pols


def _checked(run):
    """``run()``, and the message of an AssertionError that one of the
    ``--check`` gates raised after the JSON was written (None if all
    held)."""
    try:
        return run(), None
    except AssertionError as e:
        return None, str(e)


class _Capture:
    """stdout into a list, the ``wrote`` line (its path) dropped."""

    def __enter__(self):
        import io

        self.buf, self.old = io.StringIO(), sys.stdout
        sys.stdout = self.buf

    def __exit__(self, *exc):
        sys.stdout = self.old

    def lines(self):
        return [line for line in self.buf.getvalue().splitlines()
                if not line.startswith("wrote ")]


@pytest.mark.parametrize("run", list(FLAGS))
def test_printed_tables_equal(sweeps, run):
    out, _ = sweeps
    assert out[run]["port"][0] == out[run]["ref"][0]
    assert any("cluster-total energy [kJ], P=2 workers" in line
               for line in out[run]["port"][0])


@pytest.mark.parametrize("run", list(FLAGS))
def test_json_equal_byte_for_byte(sweeps, run):
    out, _ = sweeps
    assert out[run]["port"][1] == out[run]["ref"][1]


@pytest.mark.parametrize("run", list(FLAGS))
def test_checks_fell_alike(sweeps, run):
    """``--check`` held or failed in both packages with the same message
    (these are untrained qnets; the memory run lacks the queue-trained
    method the first gate needs)."""
    out, _ = sweeps
    assert out[run]["port"][2][1] == out[run]["ref"][2][1]
    assert out[run]["port"][2][1] is not None


def test_mem_gates_on_the_sweep_fall_alike(sweeps):
    """``check_mem_acceptance`` on each package's own memory axis."""
    out, _ = sweeps
    outcomes = []
    for side, mod in (("ref", rsweep), ("port", psweep)):
        result = json.loads(out["mem"][side][1])
        result["mem"] = {int(k): v for k, v in result["mem"].items()}
        outcomes.append(_outcome(mod.check_mem_acceptance, result, 2))
    assert outcomes[0] == outcomes[1]


def test_the_policies_decide(sweeps):
    """Over 5 epochs of 8 steps the deployed qnets act: some greendygnn
    cell's energy leaves static_w's."""
    out, _ = sweeps
    rows = json.loads(out["axes"]["port"][1])["rows"]
    assert any(cells[m]["total_kj"] != cells["static_w"]["total_kj"]
               for by_sc in rows.values() for cells in by_sc.values()
               for m in ("greendygnn", "greendygnn_queue"))


def test_the_sweep_covers_every_axis(sweeps):
    out, _ = sweeps
    got = json.loads(out["axes"]["port"][1])
    assert list(got["rows"]) == ["2", "3"]
    for P in ("2", "3"):
        assert list(got["rows"][P]) == [
            "clean", "hot_owner", "slow_worker", "demand_skew",
            "injected:bursty_markov", "injected:incast"]
        for cells in got["rows"][P].values():
            assert list(cells) == ["dgl", "bgl", "static_w",
                                   "greendygnn_queue", "greendygnn"]
        assert list(got["mixtures"][P]) == [
            "all_static", "all_greendygnn", "gdg_on_straggler",
            "gdg_on_symmetric"]
        shares = got["hot_share"][P]
        assert shares["demand_skew"][0] > shares["balanced"][0]


def test_memory_axis_gates(sweeps):
    """The unlimited budget equals the in-RAM store, the paired
    greendygnn cell is deterministic, and the tight budget moves blocks
    and evicts: in the port, as in the reference."""
    out, _ = sweeps
    got = json.loads(out["mem"]["port"][1])["mem"]["2"]
    want = json.loads(out["mem"]["ref"][1])["mem"]["2"]
    assert got == want
    assert got["unlimited_parity"] is True
    cell = got["rows"]["tight"]["greendygnn"]
    assert cell["deterministic"] is True
    tc = cell["tier_counts"]
    assert tc["block_fetches"] > 0 and tc["evictions"] > 0
    assert tc["device_hits"] > 0


def test_policies_asked_for_alike(sweeps):
    """The same policies, under the reference's artifact names: the
    cluster twin's and the queue env's a P, the headroom-aware one a
    budget level."""
    _, pols = sweeps
    assert pols.calls["port"] == pols.calls["ref"]
    assert [(c["name"], c["env"]) for c in pols.calls["port"]] == [
        ("qnet_sweep", "cluster"), ("qnet_sweep_p2", "queue"),
        ("qnet_sweep", "cluster"), ("qnet_sweep_p3", "queue"),
        ("qnet_sweep", "cluster"), ("qnet_sweep_mem_tight", "cluster")]
    assert pols.calls["port"][5]["cluster_kwargs"] == {
        "mem_budget_frac": 0.2, "observe_headroom": True}


def test_get_q_fns_trains_only_what_is_deployed(sweeps, monkeypatch):
    _, pols = sweeps
    monkeypatch.setattr(ppol, "get_or_train_policy", pols.fake("port"))
    cfg = psweep.base_cfg("reddit", 600, device="cpu", n_parts=4)
    before = len(pols.calls["port"])
    assert psweep.get_q_fns(cfg, None, 5, False, {"dgl", "bgl"}) == {}
    assert list(psweep.get_q_fns(cfg, None, 5, False,
                                 {"greendygnn_queue"})) == [
        "greendygnn_queue"]
    assert pols.calls["port"][before:] == [dict(
        name="qnet_sweep_p4", iterations=5, force=False, env="queue",
        n_owners=3)]


@pytest.mark.parametrize("spec", ["tight,loose", "0.15, 0.5", "tight,,",
                                  "", " , ", "tight,x"])
def test_parse_mem_levels_alike(spec):
    def outcome(mod):
        try:
            return mod.parse_mem_levels(spec)
        except ValueError as e:
            return f"ValueError: {e}"
    assert outcome(psweep) == outcome(rsweep)


def test_emergent_scenarios_equal():
    got = psweep.emergent_scenarios(4, 0.35, 1.5)
    assert got == rsweep.emergent_scenarios(4, 0.35, 1.5)
    assert got["hot_owner"][1]["link_rate_scale"] == (0.35, 1.0, 1.0, 1.0)


# ------------------------------------------- the gates on synthetic dicts
EMERGENT = ("clean", "hot_owner", "slow_worker", "demand_skew")


def _passing() -> dict:
    """A result that every gate of ``check_acceptance`` at P = 4 lets
    through: greendygnn below every static fleet and below the
    queue-trained policy everywhere, queueing on every scenario."""
    rows = {}
    for i, name in enumerate(EMERGENT + ("injected:incast",)):
        rows[name] = {
            "dgl": {"total_kj": 10.0 + i, "queue_s": 0.5},
            "bgl": {"total_kj": 9.0 + i, "queue_s": 0.5},
            "static_w": {"total_kj": 8.0 + i, "queue_s": 0.5},
            "greendygnn_queue": {"total_kj": 7.5 + i, "queue_s": 0.4},
            "greendygnn": {"total_kj": 7.0 + i, "queue_s": 0.3},
        }
    return {"rows": {4: rows}}


def _set(key_path, value):
    def edit(result):
        node = result
        for k in key_path[:-1]:
            node = node[k]
        node[key_path[-1]] = value
    return edit


def _drop(key_path):
    def edit(result):
        node = result
        for k in key_path[:-1]:
            node = node[k]
        del node[key_path[-1]]
    return edit


def _each(names, key, value):
    def edit(result):
        for n in names:
            result["rows"][4][n][key]["total_kj"] = value(result, n)
    return edit


ACCEPTANCE_CASES = {
    "passes": lambda r: None,
    "no_rows_at_p": _drop(("rows", 4)),
    "no_queue_method": _drop(("rows", 4, "hot_owner", "greendygnn_queue")),
    "no_emergent_queueing": _set(
        ("rows", 4, "slow_worker", "greendygnn", "queue_s"), 0.0),
    "injected_queueing_not_needed": _set(
        ("rows", 4, "injected:incast", "greendygnn", "queue_s"), 0.0),
    "one_static_win": _each(
        ("clean", "hot_owner", "slow_worker"), "greendygnn",
        lambda r, n: r["rows"][4][n]["static_w"]["total_kj"]),
    "no_static_method": lambda r: [
        r["rows"][4][n].pop(m) for n in r["rows"][4]
        for m in ("dgl", "bgl", "static_w")],
    "worse_than_queue_on_stress": _each(
        ("demand_skew",), "greendygnn_queue",
        lambda r, n: r["rows"][4][n]["greendygnn"]["total_kj"] - 0.01),
    "clean_within_band": _each(
        ("clean",), "greendygnn_queue",
        lambda r, n: r["rows"][4][n]["greendygnn"]["total_kj"] / 1.04),
    "clean_outside_band": _each(
        ("clean",), "greendygnn_queue",
        lambda r, n: r["rows"][4][n]["greendygnn"]["total_kj"] / 1.06),
    "one_strict_win": _each(
        ("hot_owner", "slow_worker"), "greendygnn_queue",
        lambda r, n: r["rows"][4][n]["greendygnn"]["total_kj"]),
}


def _outcome(check, result, *args):
    try:
        check(result, *args)
        return "passed"
    except AssertionError as e:
        return f"AssertionError: {e}"


@pytest.mark.parametrize("case", list(ACCEPTANCE_CASES))
def test_check_acceptance_raises_alike(case, capsys):
    result = _passing()
    ACCEPTANCE_CASES[case](result)
    got = _outcome(psweep.check_acceptance, copy.deepcopy(result), 4)
    port_out = capsys.readouterr().out
    want = _outcome(rsweep.check_acceptance, copy.deepcopy(result), 4)
    assert got == want
    assert port_out == capsys.readouterr().out
    assert (got == "passed") == (case in (
        "passes", "injected_queueing_not_needed", "clean_within_band"))


def _mem_passing() -> dict:
    tc = {"block_fetches": 12, "evictions": 3, "host_hits": 40,
          "device_hits": 90}
    return {"mem": {4: {
        "unlimited_parity": True,
        "levels": {"tight": 0.2, "loose": 0.6},
        "rows": {level: {
            "dgl": {"total_kj": 10.0}, "bgl": {"total_kj": 9.0},
            "static_w": {"total_kj": 8.0},
            "greendygnn": {"total_kj": 7.0, "tier_counts": dict(tc),
                           "deterministic": True},
        } for level in ("tight", "loose")},
    }}}


MEM_CASES = {
    "passes": lambda r: None,
    "no_mem_axis": _drop(("mem",)),
    "no_mem_at_p": _drop(("mem", 4)),
    "unlimited_differs": _set(("mem", 4, "unlimited_parity"), False),
    "no_block_fetches": _set(("mem", 4, "rows", "tight", "greendygnn",
                              "tier_counts", "block_fetches"), 0),
    "no_evictions": _set(("mem", 4, "rows", "tight", "greendygnn",
                          "tier_counts", "evictions"), 0),
    "no_tier_counts": _set(("mem", 4, "rows", "tight", "greendygnn",
                            "tier_counts"), None),
    "not_deterministic": _set(("mem", 4, "rows", "tight", "greendygnn",
                               "deterministic"), False),
    "loses_to_static": _set(("mem", 4, "rows", "tight", "greendygnn",
                             "total_kj"), 8.0),
    "loose_level_not_gated": _set(("mem", 4, "rows", "loose", "greendygnn",
                                   "total_kj"), 99.0),
    "no_static_method": lambda r: [
        r["mem"][4]["rows"]["tight"].pop(m) for m in ("dgl", "bgl",
                                                      "static_w")],
}


@pytest.mark.parametrize("case", list(MEM_CASES))
def test_check_mem_acceptance_raises_alike(case, capsys):
    result = _mem_passing()
    MEM_CASES[case](result)
    got = _outcome(psweep.check_mem_acceptance, copy.deepcopy(result), 4)
    port_out = capsys.readouterr().out
    want = _outcome(rsweep.check_mem_acceptance, copy.deepcopy(result), 4)
    assert got == want
    assert port_out == capsys.readouterr().out
    assert (got == "passed") == (case in ("passes", "loose_level_not_gated"))


def test_the_card_is_refused_without_one():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        psweep.main(FLAGS["axes"])
