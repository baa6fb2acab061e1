"""The port's paper harness (``repro_torch.paper``) against the
reference's ``benchmarks/``, on the CPU at a small grid.

Both sides sweep ``reddit`` at batch 600 over 6 epochs of 4 steps (2 of
warmup; the closed form's paper schedule congests epochs 3 and 4) under
one seeded qnet: the reference's ``benchmarks.common`` constants, the
names each figure imported from it, ``RESULTS_DIR`` and the sweep's
policy are patched; the port's sweep takes the same grid as arguments.
The modeled lane is digest-equal across the packages, so the modeled
tables and figures (Table I, Table II, Figs. 1, 5, 6, 7 and 9) must
print the same rows and write the same JSON, byte for byte. Fig. 8's
predictions come from the table simulator in float32 on both sides and
agree within rtol 1e-5 (its measured step times are equal); the
pipeline-overlap check's parity report is equal (its wall times are the
host's and are not compared).
"""
import io
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks import common as rcommon  # noqa: E402
from benchmarks import (  # noqa: E402
    fig1_rpc_energy as rfig1,
    fig5_overhead as rfig5,
    fig6_clean as rfig6,
    fig7_adaptation as rfig7,
    fig8_sim_validation as rfig8,
    fig9_cumulative as rfig9,
    pipeline_overlap as rpipe,
    roofline_report as rroof,
    table1_energy as rtable1,
    table2_ablation as rtable2,
)
from repro.core import controller as rctl  # noqa: E402
from repro.core import dqn as rdqn  # noqa: E402
from repro_torch.core import dqn as pdqn  # noqa: E402
from repro_torch.paper import (  # noqa: E402
    fig1_rpc_energy as pfig1,
    fig5_overhead as pfig5,
    fig6_clean as pfig6,
    fig7_adaptation as pfig7,
    fig8_sim_validation as pfig8,
    fig9_cumulative as pfig9,
    pipeline_overlap as ppipe,
    roofline_report as proof,
    run as prun,
    table1_energy as ptable1,
    table2_ablation as ptable2,
)
from repro_torch.paper.common import Sweep  # noqa: E402
from _jax_release import release_jax_executables  # noqa: E402,F401

GRID = dict(datasets=["reddit"], batch_sizes=[600], n_epochs=6,
            steps_per_epoch=4)
BATCH = 600
TOL_FIG8 = dict(rtol=1e-5, atol=0.0)

# (port module, reference module, keyword arguments of both mains)
MODELED = {
    "fig1_rpc_energy": (pfig1, rfig1, {}),
    "table1_energy": (ptable1, rtable1, {}),
    "table2_ablation": (ptable2, rtable2, dict(batch=BATCH)),
    "fig5_overhead": (pfig5, rfig5, dict(batch=BATCH)),
    "fig6_clean": (pfig6, rfig6, dict(batch=BATCH)),
    "fig7_adaptation": (pfig7, rfig7, dict(dataset="reddit", batch=BATCH)),
    "fig9_cumulative": (pfig9, rfig9, dict(batch=BATCH)),
}


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """(reference's results dir, port's sweep): both at :data:`GRID`
    under one seeded qnet, the reference's through its patched module
    globals (restored at the module's end)."""
    qnet = rdqn.init_qnet(jax.random.PRNGKey(1), rctl.state_dim(3),
                          rctl.n_actions(3))
    path = str(tmp_path_factory.mktemp("qnet") / "qnet.npz")
    rdqn.save_qnet(path, qnet)
    fwd = jax.jit(rdqn.q_forward)

    def ref_q(state):
        return np.asarray(fwd(qnet, jnp.asarray(state, jnp.float32)))

    ref_dir = str(tmp_path_factory.mktemp("ref_results"))
    port_dir = str(tmp_path_factory.mktemp("port_results"))
    ref_sweep = rcommon.Sweep()
    ref_sweep._q_fn = ref_q
    mp = pytest.MonkeyPatch()
    for mod, names in [(rcommon, ("DATASETS", "BATCH_SIZES")),
                       (rtable1, ("DATASETS", "BATCH_SIZES")),
                       (rtable2, ("DATASETS",)), (rfig5, ("DATASETS",)),
                       (rfig6, ("DATASETS",)), (rfig9, ("DATASETS",))]:
        for name in names:
            mp.setattr(mod, name, list(GRID[name.lower()]))
    mp.setattr(rcommon, "N_EPOCHS", GRID["n_epochs"])
    mp.setattr(rcommon, "STEPS_PER_EPOCH", GRID["steps_per_epoch"])
    mp.setattr(rcommon, "RESULTS_DIR", ref_dir)
    mp.setattr(rcommon, "_GLOBAL_SWEEP", ref_sweep)
    port = Sweep(**GRID, device="cpu",
                 q_fn=pdqn.q_fn_of(pdqn.load_qnet(path)),
                 results_dir=port_dir)
    yield ref_dir, port
    mp.undo()


def _json(directory, name):
    with open(os.path.join(directory, f"{name}.json")) as f:
        return f.read()


@pytest.mark.parametrize("name", list(MODELED))
def test_modeled_rows_and_json_equal(sweeps, name):
    ref_dir, port = sweeps
    pmod, rmod, kw = MODELED[name]
    assert pmod.main(port, **kw) == rmod.main(**kw)
    assert _json(port.results_dir, name) == _json(ref_dir, name)


def test_the_small_grid_is_congested(sweeps):
    """The comparisons above see congestion: greendygnn's window moves
    and Fig. 5's overheads are positive."""
    _, port = sweeps
    res = port.run("reddit", BATCH, "greendygnn", True)
    assert (res.sigma_trace.max(axis=1) > 1.05).any()
    assert port.totals("reddit", BATCH, "dgl", True)["total_kj"] \
        > port.totals("reddit", BATCH, "dgl", False)["total_kj"]


def test_fig8_predictions_within_tolerance(sweeps):
    """The full 7 x 6 (W, delta) grid: measured step times equal, the
    table simulator's predictions within :data:`TOL_FIG8`."""
    ref_dir, port = sweeps
    rows = pfig8.main(port, batch=BATCH)
    ref_rows = rfig8.main(batch=BATCH)
    assert rows[-1] == ref_rows[-1] == "fig8/grid_points,42,"
    got = json.loads(_json(port.results_dir, "fig8_sim_validation"))
    want = json.loads(_json(ref_dir, "fig8_sim_validation"))
    assert [(g["W"], g["delta_ms"], g["meas_ms"]) for g in got] \
        == [(w["W"], w["delta_ms"], w["meas_ms"]) for w in want]
    for key in ("pred_ms", "err_pct"):
        np.testing.assert_allclose([g[key] for g in got],
                                   [w[key] for w in want], **TOL_FIG8)


def test_pipeline_overlap_parity_equal(sweeps):
    """The threaded pipeline against the synchronous run: the same parity
    report, rebuild count and window on both sides."""
    ref_dir, port = sweeps
    kw = dict(dataset="reddit", batch=BATCH, window=4, n_epochs=3,
              steps_per_epoch=4)
    rows = ppipe.main(port, **kw)
    ref_rows = rpipe.main(**kw)
    kept = ("/W,", "/n_rebuilds,", "/parity,")
    assert [r for r in rows if any(k in r for k in kept)] \
        == [r for r in ref_rows if any(k in r for k in kept)]
    assert "pipeline/reddit/parity,OK,12 steps, 0 mismatched" in rows
    got = json.loads(_json(port.results_dir, "pipeline_overlap"))
    want = json.loads(_json(ref_dir, "pipeline_overlap"))
    for key in ("parity_ok", "parity_steps", "n_rebuilds", "window"):
        assert got[key] == want[key]


def _raising(exc):
    def main(sw):
        raise exc
    return types.SimpleNamespace(main=main)


def test_run_reports_a_failing_module_and_goes_on(sweeps, capsys):
    """A module that raises prints its ``ERROR`` row (the reference's
    format), the next module still runs, and ``run_all`` names it."""
    _, port = sweeps
    out = io.StringIO()
    failed = prun.run_all(port, [("boom", _raising(ValueError("bad cell"))),
                                 ("fig1_rpc_energy", pfig1)], out=out)
    lines = out.getvalue().splitlines()
    assert failed == ["boom"]
    assert lines[0] == "name,value,derived"
    assert lines[1] == "boom/ERROR,ValueError,bad cell"
    assert lines[2].startswith("boom/wall_s,")
    assert "fig1/payload_crossover_nodes,10000,paper: crossover above " \
        "~1000 nodes" in lines
    assert "ValueError: bad cell" in capsys.readouterr().err


@pytest.mark.parametrize("fails", [False, True], ids=["ok", "error"])
def test_run_main_exit_status(sweeps, monkeypatch, fails, capsys):
    """``python -m repro_torch.paper.run`` exits 1 after a module raised,
    0 when none did."""
    _, port = sweeps
    modules = [("fig1_rpc_energy", pfig1)]
    if fails:
        modules.insert(0, ("boom", _raising(RuntimeError("no card"))))
    monkeypatch.setattr(prun, "MODULES", modules)
    monkeypatch.setattr(prun, "Sweep",
                        lambda device: Sweep(device=device,
                                             results_dir=port.results_dir))
    assert prun.main(["--device", "cpu"]) == int(fails)
    capsys.readouterr()


def test_run_covers_the_reference_list():
    """``run.MODULES`` is the reference's ``benchmarks/run.py`` list,
    in its order, the roofline report last."""
    import re

    with open(os.path.join(os.path.dirname(rcommon.__file__), "run.py")) as f:
        text = f.read()
    ref = re.findall(r'\("(\w+)", (\w+)\)', text)
    assert all(n == m for n, m in ref) and len(ref) == 10
    assert [n for n, _ in prun.MODULES] == [n for n, _ in ref]
    assert prun.MODULES[-1] == ("roofline_report", proof)


def _record(arch, shape, frac, dom, peak):
    return {"arch": arch, "shape": shape,
            "roofline": {"roofline_fraction": frac, "dominant": dom,
                         "compute_s": frac * 1e-3, "memory_s": 2.5e-4,
                         "collective_s": 0.0},
            "memory": {"peak_estimate_gb": peak}}


RECORDS = [_record("qwen3-1.7b", "train_4k", 0.7312, "compute", 61.204),
           _record("fm", "serve", 0.0421, "memory", 0.5),
           _record("pna", "molecule", 0.31251, "memory", 0.013)]


def test_roofline_report_rows_equal(tmp_path, monkeypatch):
    """The port's report over its ``meta`` and ``cuda`` records prints
    the reference's rows over the same records as ``single`` and
    ``multi``: the count rows named for the port's record sets."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    for d in (ref_dir, port_dir):
        d.mkdir()
    for i, rec in enumerate(RECORDS):
        sets = (("single", "meta"), ("multi", "cuda")) if i < 2 else (
            ("single", "meta"),)
        for ref_set, port_set in sets:
            stem = f"{rec['arch']}__{rec['shape']}"
            (ref_dir / f"{stem}__{ref_set}.json").write_text(json.dumps(rec))
            (port_dir / f"{stem}__{port_set}.json").write_text(
                json.dumps(rec))
    monkeypatch.setattr(rroof, "DRYRUN_DIR", str(ref_dir))
    want = rroof.main()
    got = proof.main(None, records_dir=port_dir)
    assert got[:-3] == want[:-3]
    assert got[:3] == [
        "roofline/fm/serve,0.042,dom=memory;compute=4.21e-05s;"
        "memory=2.50e-04s;collective=0.00e+00s;peak=0.5GB",
        "roofline/pna/molecule,0.313,dom=memory;compute=3.13e-04s;"
        "memory=2.50e-04s;collective=0.00e+00s;peak=0.013GB",
        "roofline/qwen3-1.7b/train_4k,0.731,dom=compute;compute=7.31e-04s;"
        "memory=2.50e-04s;collective=0.00e+00s;peak=61.204GB"]
    assert want[-3:] == ["roofline/cells_single,3,expect 44",
                         "roofline/cells_multi,2,expect 44",
                         "roofline/dominant_histogram,compute=1|memory=2,"]
    assert got[-3:] == ["roofline/cells_meta,3,expect 44",
                        "roofline/cells_cuda,2,the cells the card ran",
                        want[-1]]
    assert [r["arch"] for r in proof.load_records("cuda", port_dir)] == [
        "fm", "qwen3-1.7b"]


def test_roofline_report_reads_the_dryrun_records(tmp_path, monkeypatch,
                                                  capsys):
    """A record the port's dry-run writes (a sage cell on ``meta``) is
    the report's row, through the command line's ``--records``."""
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    rec = dryrun.run_cell("greendygnn-sage", "molecule", "meta")
    rows = proof.cli(["--records", str(tmp_path)])
    t = rec["roofline"]
    assert rows[0].startswith(
        f"roofline/greendygnn-sage/molecule,{t['roofline_fraction']:.3f},"
        f"dom={t['dominant']};")
    assert rows[1:] == ["roofline/cells_meta,1,expect 44",
                        "roofline/cells_cuda,0,the cells the card ran",
                        f"roofline/dominant_histogram,{t['dominant']}=1,"]
    assert capsys.readouterr().out.splitlines() == rows


@pytest.mark.parametrize("where", ["empty", "missing", "cuda_only"])
def test_roofline_report_error_row(tmp_path, monkeypatch, where):
    """No ``meta`` record: the reference's error row, nothing raised (the
    reference's own row on an empty directory is the same but for the
    command it names)."""
    d = tmp_path / "records"
    if where != "missing":
        d.mkdir()
    if where == "cuda_only":
        (d / "fm__serve__cuda.json").write_text(json.dumps(RECORDS[1]))
    rows = proof.main(None, records_dir=d)
    assert rows == ["roofline/error,no dry-run results,run python -m "
                    "repro_torch.launch.dryrun --all first"]
    monkeypatch.setattr(rroof, "DRYRUN_DIR", str(d))
    want = rroof.main()
    assert [r.split(",")[:2] for r in want] \
        == [r.split(",")[:2] for r in rows]


def test_sweep_refuses_the_card_without_one():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Sweep()


def test_roofline_report_reads_the_mesh_records(tmp_path, monkeypatch):
    """Records of the production meshes (``arch__shape__single__meta``,
    ``__multi__meta``) are the reference's ``single`` and ``multi`` sets:
    the port's mesh rows equal the reference's rows over the same records
    (each cell row named ``/single``, the count rows noting the 20 LM
    cells), after the one-device rows, which they leave as they were."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    for d in (ref_dir, port_dir):
        d.mkdir()
    for i, rec in enumerate(RECORDS):
        stem = f"{rec['arch']}__{rec['shape']}"
        sets = ("single", "multi") if i < 2 else ("single",)
        for mesh in sets:
            (ref_dir / f"{stem}__{mesh}.json").write_text(json.dumps(rec))
            (port_dir / f"{stem}__{mesh}__meta.json").write_text(
                json.dumps(rec))
        (port_dir / f"{stem}__meta.json").write_text(json.dumps(rec))
    monkeypatch.setattr(rroof, "DRYRUN_DIR", str(ref_dir))
    want = rroof.main()
    got = proof.main(None, records_dir=port_dir)
    assert got[:6] == want[:3] + [
        "roofline/cells_meta,3,expect 44",
        "roofline/cells_cuda,0,the cells the card ran", want[-1]]
    mesh = got[6:]
    assert [r.replace("/single,", ",", 1) for r in mesh[:3]] == want[:3]
    assert mesh[3:] == [
        "roofline/cells_single,3,expect 44; the LM cells' 20 here",
        "roofline/cells_multi,2,expect 44; the LM cells' 20 here",
        want[-1].replace("histogram", "histogram_single")]
    assert len(proof.load_records("meta", port_dir)) == 3


def test_roofline_report_reads_a_dryrun_mesh_record(tmp_path, monkeypatch):
    """A record of ``launch.dryrun --mesh single`` (TinyLlama's decode
    step, rank 0 of 16 x 16, on ``meta``) is a mesh row with its
    collective term."""
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k", "meta",
                          mesh="single")
    assert (tmp_path / "tinyllama-1.1b__decode_32k__single__meta.json"
            ).exists()
    assert rec["n_devices"] == 256 and rec["roofline"]["collective_s"] > 0
    rows = proof.mesh_rows(tmp_path)
    t = rec["roofline"]
    assert rows[0].startswith(
        f"roofline/tinyllama-1.1b/decode_32k/single,"
        f"{t['roofline_fraction']:.3f},dom={t['dominant']};")
    assert f"collective={t['collective_s']:.2e}s" in rows[0]
    assert rows[1:3] == [
        "roofline/cells_single,1,expect 44; the LM cells' 20 here",
        "roofline/cells_multi,0,expect 44; the LM cells' 20 here"]
