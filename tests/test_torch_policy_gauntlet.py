"""The port's policy gauntlet (``repro_torch.paper.policy_gauntlet``)
against the reference's ``benchmarks/policy_gauntlet.py``, on the CPU.

``build_pools`` gives the reference's pools: the ``--quick`` path's
trace-derived theta, Algorithm 1's and the table calibration's, bit for
bit. ``train_policies`` asks for the reference's policies under its
artifact names, and a short real training run on the CPU writes them.
Both command lines then run on the same flags (``reddit`` at batch 600,
5 epochs of 8 steps, every registry scenario against the three baselines
and the three trained columns) with each package's
``get_or_train_policy`` returning one seeded qnet per env, the same
network on both sides: the printed grid, the written JSON and the
``--check`` outcome must be equal. ``check_acceptance`` must raise where
the reference's raises, with its message, on synthetic rows.
"""
import argparse
import copy
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks import common as rcommon  # noqa: E402
from benchmarks import policy_gauntlet as rgaunt  # noqa: E402
from repro.core import controller as rctl  # noqa: E402
from repro.core import dqn as rdqn  # noqa: E402
from repro.train import gnn_trainer as rgt  # noqa: E402
from repro.train import policy as rpol  # noqa: E402
from repro_torch.core import dqn as pdqn  # noqa: E402
from repro_torch.paper import policy_gauntlet as pgaunt  # noqa: E402
from repro_torch.train import gnn_trainer as pgt  # noqa: E402
from repro_torch.train import policy as ppol  # noqa: E402
from _jax_release import release_jax_executables  # noqa: E402,F401

FLAGS = ["--batch", "600", "--steps", "40", "--steps-per-epoch", "8",
         "--iterations", "10", "--train-epochs", "2", "--n-envs", "4"]


def _args(**kw):
    base = dict(dataset="reddit", batch=600, steps=12, steps_per_epoch=4,
                iterations=4, train_epochs=2, n_envs=4,
                train_envs=list(rgaunt.TRAIN_ENVS), scenarios="", seed=0,
                quick=True, force=False, check=False, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture(scope="module")
def bundles():
    """(reference's cfg, bundle; port's cfg, bundle) at :func:`_args`'s
    3 epochs of 4 steps."""
    args = _args()
    rcfg = dataclasses.replace(
        rcommon.base_cfg(args.dataset, args.batch), n_epochs=3,
        steps_per_epoch=args.steps_per_epoch, seed=args.seed)
    pcfg = dataclasses.replace(
        pgaunt.base_cfg(args.dataset, args.batch, device="cpu"), n_epochs=3,
        steps_per_epoch=args.steps_per_epoch, seed=args.seed)
    return rcfg, rgt.build_trace(rcfg), pcfg, pgt.build_trace(pcfg)


def _assert_pools_equal(got, want):
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(
            getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)),
            err_msg=f.name)


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "algorithm1"])
def test_build_pools_bit_equal(bundles, quick):
    rcfg, rb, pcfg, pb = bundles
    args = _args(quick=quick)
    got = pgaunt.build_pools(args, pcfg, pb)
    want = rgaunt.build_pools(args, rcfg, rb)
    assert list(got) == list(want) == ["table", "analytic", "queue"]
    for env in got:
        _assert_pools_equal(got[env], want[env])
    assert got["analytic"] is got["queue"]
    if quick:      # the trace's own scales, not the published ones
        assert float(got["queue"].remote_nodes[0]) > 100.0


@pytest.mark.parametrize("envs", [["analytic"], ["table"], ["queue"]])
def test_build_pools_only_what_is_trained(bundles, envs):
    rcfg, rb, pcfg, pb = bundles
    args = _args(train_envs=envs)
    assert list(pgaunt.build_pools(args, pcfg, pb)) \
        == list(rgaunt.build_pools(args, rcfg, rb)) == envs


def _recorder(calls):
    def get_or_train_policy(pool, name="qnet", iterations=40_000,
                            force=False, env=None, device="cuda", **kw):
        calls.append(dict(name=name, iterations=iterations, force=force,
                          env=env, **kw))
        return None, None
    return get_or_train_policy


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "calibrated"])
def test_train_policies_ask_for_the_reference_names(bundles, monkeypatch,
                                                   quick):
    rcfg, _, pcfg, _ = bundles
    calls = {"ref": [], "port": []}
    monkeypatch.setattr(rpol, "get_or_train_policy", _recorder(calls["ref"]))
    monkeypatch.setattr(ppol, "get_or_train_policy",
                        _recorder(calls["port"]))
    args = _args(quick=quick)
    pools = dict.fromkeys(args.train_envs)
    assert list(pgaunt.train_policies(args, pools, pcfg)) == list(
        rgaunt.train_policies(args, pools, rcfg)) == args.train_envs
    assert calls["port"] == calls["ref"]
    name = "qnet_gauntlet_reddit_b600_t12x4_i4_e2_n4_s0" + (
        "_quick" if quick else "")
    assert [(c["name"], c["env"]) for c in calls["port"]] == [
        (name, env) for env in args.train_envs]
    assert {(c["n_epochs"], c["n_envs"], c["seed"]) for c in calls["port"]} \
        == {(2, 4, 0)}


def test_train_policies_write_the_reference_artifacts(bundles, tmp_path,
                                                      monkeypatch):
    """A real, short training of each env on the CPU: the artifacts land
    under the reference's names, and each q_fn answers a state of the
    deployed width."""
    _, _, pcfg, pb = bundles
    monkeypatch.setattr(ppol, "ARTIFACT_DIR", str(tmp_path))
    args = _args()
    q_fns = pgaunt.train_policies(args, pgaunt.build_pools(args, pcfg, pb),
                                  pcfg)
    stem = "qnet_gauntlet_reddit_b600_t12x4_i4_e2_n4_s0_quick"
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{stem}_{env}.{ext}" for env in args.train_envs
        for ext in ("npz", "json"))
    state = np.zeros(rctl.state_dim(3), np.float32)
    for env, q in q_fns.items():
        assert np.asarray(q(state)).shape == (rctl.n_actions(3),), env


class Carried:
    """Each package's ``get_or_train_policy`` returning one seeded qnet
    per env, the same network on both sides."""

    def __init__(self, tmp):
        self.tmp, self.nets = tmp, {}

    def net(self, env):
        if env not in self.nets:
            net = rdqn.init_qnet(jax.random.PRNGKey(len(self.nets) + 11),
                                 rctl.state_dim(3), rctl.n_actions(3))
            path = os.path.join(self.tmp, f"{env}.npz")
            rdqn.save_qnet(path, net)
            self.nets[env] = (path, net)
        return self.nets[env]

    def fake(self, side):
        def get_or_train_policy(pool, name="qnet", iterations=40_000,
                                force=False, env=None, device="cuda", **kw):
            path, net = self.net(env)
            if side == "port":
                qnet = pdqn.load_qnet(path)
                return pdqn.q_fn_of(qnet), qnet
            fwd = jax.jit(rdqn.q_forward)
            return (lambda s: np.asarray(fwd(net, jnp.asarray(
                s, jnp.float32)))), net
        return get_or_train_policy


@pytest.fixture(scope="module")
def gauntlets(tmp_path_factory):
    """{side: (stdout lines, JSON text, the ``--check`` outcome)} of both
    command lines on :data:`FLAGS` with ``--quick --check``."""
    tmp = tmp_path_factory.mktemp("gauntlet")
    carried = Carried(str(tmp))
    mp = pytest.MonkeyPatch()
    mp.setattr(rpol, "get_or_train_policy", carried.fake("ref"))
    mp.setattr(ppol, "get_or_train_policy", carried.fake("port"))
    flags = FLAGS + ["--quick", "--check"]
    out = {}
    try:
        for side, mod in (("ref", rgaunt), ("port", pgaunt)):
            results = str(tmp / side)
            if side == "ref":
                mp.setattr(rcommon, "RESULTS_DIR", results)
                mp.setattr(sys, "argv", ["policy_gauntlet.py", *flags])
                main = mod.main
            else:
                mp.setattr(pgaunt, "RESULTS_DIR", results)

                def main():
                    return pgaunt.main([*flags, "--device", "cpu"])
            capture = _Capture()
            with capture:
                try:
                    main()
                    outcome = "passed"
                except SystemExit as e:
                    outcome = str(e)
            with open(os.path.join(results, "policy_gauntlet.json")) as f:
                out[side] = (capture.lines(), f.read(), outcome)
    finally:
        mp.undo()
    return out


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


def test_gauntlet_grid_printed_equal(gauntlets):
    assert gauntlets["port"][0] == gauntlets["ref"][0]


def test_gauntlet_json_equal_byte_for_byte(gauntlets):
    assert gauntlets["port"][1] == gauntlets["ref"][1]
    rows = json.loads(gauntlets["port"][1])["rows"]
    assert list(rows) == rgaunt.default_scenarios()
    assert all(list(cols) == ["dgl", "bgl", "static_w", "dqn_analytic",
                              "dqn_table", "dqn_queue"]
               for cols in rows.values())
    # the carried qnets decide: some trained column leaves static_w
    assert any(cols[c]["total_kj"] != cols["static_w"]["total_kj"]
               for cols in rows.values()
               for c in ("dqn_analytic", "dqn_table", "dqn_queue"))


def test_gauntlet_check_fell_alike(gauntlets):
    assert gauntlets["port"][2] == gauntlets["ref"][2]


def test_run_gauntlet_rows_equal_on_one_namespace(bundles, tmp_path,
                                                  monkeypatch):
    """``run_gauntlet`` of both packages on one namespace and carried
    qnets, over a subset of the scenarios and the envs."""
    rcfg, rb, pcfg, pb = bundles
    carried = Carried(str(tmp_path))
    args = _args(scenarios="clean,incast", train_envs=["queue"])
    ref_q = {"queue": carried.fake("ref")(None, env="queue")[0]}
    port_q = {"queue": carried.fake("port")(None, env="queue")[0]}
    assert pgaunt.run_gauntlet(args, pcfg, pb, port_q) \
        == rgaunt.run_gauntlet(args, rcfg, rb, ref_q)


# --------------------------------------------- the gate on synthetic rows
def _rows() -> dict:
    """Rows that pass: queue below analytic on every scenario."""
    return {sc: {"dqn_analytic": {"total_kj": 10.0 + i},
                 "dqn_queue": {"total_kj": 9.5 + i}}
            for i, sc in enumerate(("clean", "bursty_markov", "incast",
                                    "diurnal"))}


def _kj(sc, col, value):
    def edit(rows):
        rows[sc][col]["total_kj"] = value(rows)
    return edit


CASES = {
    "passes": lambda r: None,
    "no_clean": lambda r: r.pop("clean"),
    "no_incast": lambda r: r.pop("incast"),
    "no_analytic": lambda r: r["diurnal"].pop("dqn_analytic"),
    "no_queue": lambda r: r["clean"].pop("dqn_queue"),
    "within_2pct_elsewhere": _kj("diurnal", "dqn_queue",
                                 lambda r: 13.0 * 1.015),
    "over_2pct_elsewhere": _kj("diurnal", "dqn_queue",
                               lambda r: 13.0 * 1.025),
    "tie_on_must_win": _kj("incast", "dqn_queue", lambda r: 12.0),
    "above_on_must_win": _kj("bursty_markov", "dqn_queue", lambda r: 11.1),
    "clean_within_5pct": _kj("clean", "dqn_queue", lambda r: 10.0 * 1.04),
    "clean_over_5pct": _kj("clean", "dqn_queue", lambda r: 10.0 * 1.06),
    "two_failures": lambda r: [_kj("incast", "dqn_queue",
                                   lambda r: 12.5)(r),
                               _kj("clean", "dqn_queue",
                                   lambda r: 11.0)(r)],
}


def _outcome(rows, mod, **kw):
    try:
        mod.check_acceptance(rows, **kw)
        return "passed"
    except SystemExit as e:
        return f"SystemExit: {e}"


@pytest.mark.parametrize("case", list(CASES))
def test_check_acceptance_raises_alike(case, capsys):
    rows = _rows()
    CASES[case](rows)
    got = _outcome(copy.deepcopy(rows), pgaunt)
    port_out = capsys.readouterr().out
    want = _outcome(copy.deepcopy(rows), rgaunt)
    assert got == want
    assert port_out == capsys.readouterr().out
    assert (got == "passed") == (case in (
        "passes", "within_2pct_elsewhere", "clean_within_5pct"))


@pytest.mark.parametrize("tols", [dict(tol_eq=0.03), dict(tol_clean=0.07)])
def test_check_acceptance_tolerances_alike(tols):
    rows = _rows()
    _kj("diurnal", "dqn_queue", lambda r: 13.0 * 1.025)(rows)
    _kj("clean", "dqn_queue", lambda r: 10.0 * 1.06)(rows)
    assert _outcome(copy.deepcopy(rows), pgaunt, **tols) \
        == _outcome(copy.deepcopy(rows), rgaunt, **tols)


def test_the_card_is_refused_without_one():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pgaunt.main(FLAGS)
