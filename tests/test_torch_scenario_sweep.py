"""The port's scenario sweep (``repro_torch.paper.scenario_sweep``)
against the reference's ``benchmarks/scenario_sweep.py``, on the CPU.

Both packages run their command line on the same flags: ``reddit`` at
batch 600, 2 epochs of 4 steps, every registry scenario against dgl,
bgl, static_w and heuristic, at P = 1 and as a 2-worker cluster, with
``--check-clean-parity``. The heuristic method needs no policy and the
modeled lane is digest-equal across the packages, so the printed grid
and the written JSON must be equal byte for byte, and the clean-parity
check (the 5% closed-form band and the bit-equal hit/miss streams) must
pass on both and fail alike. ``--trace`` payloads are written, reconciled
and equal byte for byte.
"""
import argparse
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks import common as rcommon  # noqa: E402
from benchmarks import scenario_sweep as rscen  # noqa: E402
from repro_torch.paper import scenario_sweep as pscen  # noqa: E402
from _jax_release import release_jax_executables  # noqa: E402,F401

FLAGS = ["--batch", "600", "--steps", "8", "--steps-per-epoch", "4"]


def _args(**kw):
    base = dict(dataset="reddit", batch=600, steps=8, steps_per_epoch=4,
                seed=0, scenarios="", methods=",".join(rscen.DEFAULT_METHODS),
                workers=1, trace=False, check_clean_parity=False,
                device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """(reference's results dir, port's): each package's ``RESULTS_DIR``
    pointed at a directory of its own."""
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    monkeypatch.setattr(rcommon, "RESULTS_DIR", ref_dir)
    monkeypatch.setattr(rscen, "RESULTS_DIR", ref_dir)
    monkeypatch.setattr(pscen, "RESULTS_DIR", port_dir)
    return ref_dir, port_dir


def _run_both(dirs, monkeypatch, capsys, flags):
    """Both command lines on ``flags``: (reference's stdout, port's
    stdout, reference's result, port's result), the ``wrote`` lines
    (their paths differ) dropped from the outputs."""
    ref_dir, port_dir = dirs
    monkeypatch.setattr(sys, "argv", ["scenario_sweep.py", *flags])
    rscen.main()
    ref_out = capsys.readouterr().out
    result = pscen.main([*flags, "--device", "cpu"])
    port_out = capsys.readouterr().out

    def kept(out):
        return [line for line in out.splitlines()
                if not line.startswith("wrote ")]

    with open(os.path.join(ref_dir, "scenario_sweep.json")) as f:
        ref_json = f.read()
    with open(os.path.join(port_dir, "scenario_sweep.json")) as f:
        port_json = f.read()
    return kept(ref_out), kept(port_out), ref_json, port_json, result


@pytest.mark.parametrize("workers", [1, 2])
def test_sweep_rows_json_and_clean_parity_equal(dirs, monkeypatch, capsys,
                                                workers):
    ref_out, port_out, ref_json, port_json, result = _run_both(
        dirs, monkeypatch, capsys,
        FLAGS + ["--workers", str(workers), "--check-clean-parity"])
    assert port_out == ref_out
    assert port_json == ref_json
    assert result == json.loads(ref_json) | {"rows": result["rows"]}
    assert list(result["rows"]) == rscen.default_scenarios() \
        == pscen.default_scenarios()
    assert len(result["rows"]) == 12
    assert all(list(cells) == rscen.DEFAULT_METHODS
               for cells in result["rows"].values())
    assert "bit-reproducibility: identical hit/miss stream" in port_out[-1]


def test_run_sweep_rows_equal_on_one_namespace():
    """``run_sweep`` of both packages on the same namespace (the port
    reads its ``device``, the reference ignores it)."""
    args = _args(scenarios="clean,incast,bursty_markov", workers=2)
    assert pscen.run_sweep(args) == rscen.run_sweep(args)


@pytest.mark.parametrize("workers", [1, 2])
def test_traces_written_reconciled_and_equal(dirs, workers):
    """``--trace``: one reconciled payload a cell under each package's
    ``traces/``, equal across the packages."""
    ref_dir, port_dir = dirs
    args = _args(scenarios="clean,incast", methods="static_w,heuristic",
                 workers=workers, trace=True)
    rscen.run_sweep(args)
    pscen.run_sweep(args)
    names = sorted(os.listdir(os.path.join(ref_dir, "traces")))
    assert names == sorted(os.listdir(os.path.join(port_dir, "traces")))
    assert len(names) == 4
    assert all(n.startswith(f"scenario_sweep_p{workers}_") for n in names)
    for name in names:
        with open(os.path.join(ref_dir, "traces", name)) as f:
            want = f.read()
        with open(os.path.join(port_dir, "traces", name)) as f:
            got = f.read()
        assert got == want, name


@pytest.mark.parametrize("scale", [1.1, 0.9])
def test_clean_parity_band_raises_alike(monkeypatch, scale):
    """A closed form 10% off the fabric's energy fails the 5% band in
    both packages, with the same message."""
    msgs = []
    for mod in (rscen, pscen):
        run = mod.gt.run

        def off(cfg, bundle, run=run):
            res = run(cfg, bundle)
            if cfg.scenario is None:       # the closed form's run
                totals = res.totals()
                res.totals = lambda: dict(
                    totals, total_kj=totals["total_kj"] * scale)
            return res
        monkeypatch.setattr(mod.gt, "run", off)
        with pytest.raises(AssertionError) as e:
            mod.check_clean_parity(_args())
        monkeypatch.setattr(mod.gt, "run", run)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert msgs[0].startswith("clean fabric diverges from closed form: ")


def test_the_card_is_refused_without_one():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pscen.main(FLAGS)
