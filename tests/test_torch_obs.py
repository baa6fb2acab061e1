"""The port's greentrace (``repro_torch.obs``) against the reference's
``repro.obs``, on the CPU.

In the modeled lane a traced run is a pure function of its config, so the
port's payload must equal the reference's in canonical JSON, byte for
byte, at P=1 (``incast``) and at P=4 under a hot owner (partition 0's NIC
at 0.35), and ``python -m repro_torch.obs capture --workers 4`` must
reproduce the reference's committed ``results/traces/*.json``. Every
traced run reconciles bit for bit (its charge events replay to the
meter's totals), and tracing only observes: traced and untraced runs have
equal digests. The analyzer (attribution, top spans, waterfall, diff,
the Chrome export) gives the reference's answers on the same payload, and
each package's CLI reads the other's files. Runs that measure (the
measured lane, the threaded pipeline) are held to reconciliation, their
spans and their streams; the budgeted tier's counters to the reference's
payload.
"""
import argparse
import collections
import json
import threading

import numpy as np
import pytest

from repro.analysis import digest as dg
from repro.graph import datasets as rds
from repro.obs import __main__ as rcli
from repro.obs import dumps_canonical as ref_dumps
from repro.obs import export as rexport
from repro.obs import report as rreport
from repro.store import MemoryBudget as RefBudget
from repro.train import cluster as rcluster
from repro.train import gnn_trainer as rgt
from repro_torch.analysis import digest as pdg
from repro_torch.core.cost_model import CostModelParams
from repro_torch.core.energy import EnergyMeter, StepSample
from repro_torch.launch import roofline
from repro_torch.obs import (
    NULL_TRACER,
    ReconciliationError,
    Tracer,
    dumps_canonical,
    load_trace,
    reconcile,
    to_chrome,
    trace_digest,
    write_trace,
)
from repro_torch.obs import __main__ as pcli
from repro_torch.obs import export as pexport
from repro_torch.obs import report as preport
from repro_torch.obs import tracer as ptracer
from repro_torch.store import MemoryBudget
from repro_torch.train import cluster as pcluster
from repro_torch.train import gnn_trainer as pgt
from repro_torch.train import worker as pworker
from _jax_release import release_jax_executables  # noqa: F401

# the reference's greentrace test configuration (tests/test_obs.py)
CFG = dict(method="static_w", dataset="reddit", batch_size=600,
           n_epochs=2, steps_per_epoch=8, scenario="incast", seed=0)
HOT = (0.35, 1.0, 1.0, 1.0)
# the reference's pinned P=4 modeled run and its report digest
PIN_CFG = dict(CFG, scenario="clean")
P4_DIGEST = "41d1a2d4d2a3e26dac2bfcd3618cab19fa12ffb53b1db759670fece305fbce28"
# the measured lane at a small size, with device payloads
MEASURED = dict(method="static_w", dataset="reddit", batch_size=600,
                n_epochs=2, steps_per_epoch=4, static_window=2,
                compute="measured", seed=0)
H100 = "NVIDIA H100 80GB HBM3"


def _ref_p1(trace=True):
    return rgt.run(rgt.RunConfig(**CFG, trace=trace))


def _port_p1(trace=True):
    return pgt.run(pgt.RunConfig(**CFG, trace=trace, device="cpu"))


def _ref_p4(trace=True, hot=True):
    kw = dict(n_workers=4, link_rate_scale=HOT) if hot else dict(n_workers=4)
    return rcluster.run_cluster(rgt.RunConfig(**PIN_CFG, trace=trace),
                                rcluster.ClusterConfig(**kw))


def _port_p4(trace=True, hot=True):
    kw = dict(n_workers=4, link_rate_scale=HOT) if hot else dict(n_workers=4)
    return pcluster.run_cluster(
        pgt.RunConfig(**PIN_CFG, trace=trace, device="cpu"),
        pcluster.ClusterConfig(**kw))


@pytest.fixture(scope="module")
def ref_p1():
    return _ref_p1()


@pytest.fixture(scope="module")
def port_p1():
    return _port_p1()


@pytest.fixture(scope="module")
def ref_p4():
    return _ref_p4()


@pytest.fixture(scope="module")
def port_p4():
    return _port_p4()


@pytest.fixture(scope="module")
def port_p4_clean():
    return _port_p4(hot=False)


def _events(payload, component=None, kind=None):
    return [e for sec in payload["ranks"] for e in sec["events"]
            if (component is None or e["component"] == component)
            and (kind is None or e["kind"] == kind)]


# ---------------------------------------------------------------- modeled
class TestModeledEqualsReference:
    def test_p1_canonical_bytes(self, ref_p1, port_p1):
        assert dumps_canonical(port_p1.trace) == ref_dumps(ref_p1.trace)
        assert trace_digest(port_p1.trace) == rexport.trace_digest(
            ref_p1.trace)

    def test_p4_hot_owner_canonical_bytes(self, ref_p4, port_p4):
        assert dumps_canonical(port_p4.trace) == ref_dumps(ref_p4.trace)

    def test_capture_reproduces_committed_traces(self, tmp_path, capsys):
        """The CLI's capture at 4 workers writes the reference's committed
        artifacts byte for byte; ``--check`` holds the traced and untraced
        digests equal (the overhead gate is opened: host timings on a
        shared CPU are not what this test holds)."""
        rc = pcli.main(["capture", "--workers", "4", "--device", "cpu",
                        "--out", str(tmp_path), "--check", "--reps", "1",
                        "--overhead", "1e9"])
        out = capsys.readouterr().out
        assert rc == 0, out
        assert "check passed" in out
        for name in ("clean", "hot_owner"):
            assert (tmp_path / f"{name}.json").read_bytes() == open(
                f"results/traces/{name}.json", "rb").read()

    def test_capture_defaults(self):
        """The reference's flags and defaults, except that runs go to the
        card unless asked, and files to ``build/traces``: the committed
        ``results/traces`` are the reference's."""
        port = vars(pcli.build_parser().parse_args(["capture"]))
        assert port.pop("device") == "cuda"
        assert port.pop("out") == "build/traces"
        ref = {}
        parse = argparse.ArgumentParser.parse_args

        def grab(self, argv=None, namespace=None):
            ns = parse(self, argv, namespace)
            ref.update(vars(ns))
            raise SystemExit(0)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(argparse.ArgumentParser, "parse_args", grab)
            with pytest.raises(SystemExit):
                rcli.main(["capture"])
        assert ref.pop("out") == "results/traces"
        assert port == ref


# ---------------------------------------------------------- reconciliation
class TestReconciliation:
    def test_p1_bit_exact(self, port_p1):
        totals = reconcile(port_p1.trace)
        m = port_p1.trace["ranks"][0]["meter"]
        assert totals[0]["gpu_j"] == m["gpu_j"] == port_p1.meter.gpu_j
        assert totals[0]["cpu_j"] == m["cpu_j"] == port_p1.meter.cpu_j
        assert m["gpu_j"] > 0 and m["cpu_j"] > 0

    def test_p4_hot_owner_bit_exact(self, port_p4):
        totals = reconcile(port_p4.trace)
        assert sorted(totals) == [0, 1, 2, 3]
        for r, res in enumerate(port_p4.results):
            assert totals[r]["gpu_j"] == res.meter.gpu_j > 0
            assert totals[r]["cpu_j"] == res.meter.cpu_j
        assert port_p4.total_queue_s > 0

    def test_tampered_ledger_raises(self, port_p1):
        bad = json.loads(dumps_canonical(port_p1.trace))
        for e in bad["ranks"][0]["events"]:
            if e["kind"] == "charge":
                e["gpu_j"] = e["gpu_j"] + 1e-9
                break
        with pytest.raises(ReconciliationError):
            reconcile(bad)

    @pytest.mark.parametrize("kind", ["step", "background", "sync"])
    def test_charge_matches_meter_law(self, kind):
        params = CostModelParams()
        meter = EnergyMeter(params=params, n_nodes=1)
        tr = Tracer(rank=0, params=params)
        s = StepSample(t_compute=0.01, t_stall=0.003, t_cpu_comm=0.002,
                       remote_bytes=1e6, n_rpcs=3, gpu_overlap=0.25)
        for _ in range(3):
            if kind == "step":
                meter.record_step(s)
                tr.charge_step(0.0, s, step=0, epoch=0)
            elif kind == "background":
                meter.record_background(0.0123, 1e5, 2)
                tr.charge_background(0.0, 0.0123)
            else:
                meter.record_sync(0.004, cpu_comm_s=0.001)
                tr.charge_sync(0.0, 0.004, 0.001)
        assert (tr.gpu_j, tr.cpu_j) == (meter.gpu_j, meter.cpu_j)
        payload = pexport.build_payload([tr.section(meter)], meta={})
        assert reconcile(payload)[0]["cpu_j"] == meter.cpu_j


# ------------------------------------------------------------ invisibility
class TestInvisibility:
    def test_trace_off_yields_no_payload(self):
        assert _port_p1(trace=False).trace is None

    def test_p1_digest_equal_on_and_off(self, port_p1):
        assert pdg.result_digest(_port_p1(trace=False)) \
            == pdg.result_digest(port_p1) == dg.result_digest(port_p1)

    def test_p4_digest_equal_on_and_off(self, port_p4):
        off = _port_p4(trace=False)
        assert off.trace is None
        assert pdg.report_digest(off) == pdg.report_digest(port_p4)

    def test_pinned_p4_digest_traced(self, port_p4_clean):
        """The reference's pinned P=4 run, traced, keeps its digest."""
        assert dg.report_digest(port_p4_clean) == P4_DIGEST
        reconcile(port_p4_clean.trace)

    def test_null_tracer_is_inert(self):
        NULL_TRACER.span("x", "y", 0.0, 1.0)
        NULL_TRACER.charge_step(0.0, StepSample(1.0, 0.0), step=0, epoch=0)
        NULL_TRACER.charge_background(0.0, 1.0)
        NULL_TRACER.charge_sync(0.0, 1.0)
        NULL_TRACER.begin_window(0.0, step=0, epoch=0)
        NULL_TRACER.counter("x", "y", 0.0)
        assert NULL_TRACER.enabled is False
        assert list(NULL_TRACER.events) == []
        assert NULL_TRACER.section(None) is None


# ------------------------------------------------------------------ export
class TestExport:
    def test_chrome_equals_reference(self, ref_p4, port_p4):
        d = to_chrome(port_p4.trace)
        assert d == rexport.to_chrome(ref_p4.trace)
        evs = d["traceEvents"]
        assert {e["pid"] for e in evs} == {0, 1, 2, 3}
        b = [e for e in evs if e["ph"] == "b" and e["cat"] == "owner-link"]
        e_ = [e for e in evs if e["ph"] == "e" and e["cat"] == "owner-link"]
        assert len(b) == len(e_) > 0
        xs = [e for e in evs if e["ph"] == "X" and "gpu_j" in e["args"]]
        assert xs and all(ev["dur"] >= 0 for ev in xs)

    def test_write_and_load_round_trip(self, port_p4, tmp_path):
        path = write_trace(tmp_path / "t.json", port_p4.trace)
        assert load_trace(path) == json.loads(dumps_canonical(port_p4.trace))
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"schema": "other"}))
        with pytest.raises(ValueError, match="schema"):
            load_trace(bad)

    def test_fabric_spans_decompose_per_owner(self, port_p4):
        hot_queue = 0.0
        spans = _events(port_p4.trace, "fabric", "span")
        assert spans
        for s in spans:
            for o in s["args"]["owners"]:
                assert o["finish_s"] >= o["start_s"] >= o["ready_s"]
                assert o["queue_s"] >= 0 and o["service_s"] > 0
                if o["link"] == 0:
                    hot_queue += o["queue_s"]
        assert hot_queue > 0


# ------------------------------------------------------------------ report
class TestReportEqualsReference:
    @pytest.mark.parametrize("fn", ["attribution", "waterfall"])
    def test_view(self, fn, ref_p4, port_p4):
        assert getattr(preport, fn)(port_p4.trace) \
            == getattr(rreport, fn)(ref_p4.trace)

    def test_top_spans(self, ref_p4, port_p4):
        rows = preport.top_spans(port_p4.trace, 8)
        assert rows == rreport.top_spans(ref_p4.trace, 8)
        joules = [r["joules"] for r in rows]
        assert joules == sorted(joules, reverse=True) and joules[-1] > 0

    def test_diff_ranks_hot_link_queue_top(self, port_p4, port_p4_clean):
        rows = preport.diff(port_p4_clean.trace, port_p4.trace)
        assert rows == rreport.diff(port_p4_clean.trace, port_p4.trace)
        assert rows[0]["key"] == "link0/queue" and rows[0]["delta_j"] > 0
        att = preport.attribution(port_p4.trace)
        assert att["link0/queue"] > att["link1/queue"]
        assert preport.format_diff(port_p4_clean.trace, port_p4.trace) \
            == rreport.format_diff(port_p4_clean.trace, port_p4.trace)

    def test_format_report(self, ref_p1, port_p1):
        text = preport.format_report(port_p1.trace, 5)
        assert text == rreport.format_report(ref_p1.trace, 5)
        assert "reconciled bit-exact" in text and "waterfall" in text


class TestCliCrossLoad:
    def test_port_file_reports_in_reference_cli(self, port_p4, tmp_path,
                                                capsys):
        path = str(write_trace(tmp_path / "port.json", port_p4.trace))
        for args in (["report", path], ["report", path, "--json"]):
            assert rcli.main(args) == 0
            ref_out = capsys.readouterr().out
            assert pcli.main(args) == 0
            assert capsys.readouterr().out == ref_out

    def test_reference_files_report_in_port_cli(self, tmp_path, capsys):
        files = ["results/traces/clean.json", "results/traces/hot_owner.json"]
        for args in (["report", files[1]], ["report", "--diff", *files]):
            assert pcli.main(args) == 0
            port_out = capsys.readouterr().out
            assert rcli.main(args) == 0
            assert capsys.readouterr().out == port_out
        assert "link0/queue" in port_out
        out = tmp_path / "chrome.json"
        assert pcli.main(["report", files[1], "--chrome", str(out)]) == 0
        assert json.loads(out.read_text())["traceEvents"]


# --------------------------------------------------------------- measured
def _span_threads(monkeypatch):
    """Record the thread each span is emitted from, by (component, name)."""
    seen = collections.defaultdict(set)
    span = ptracer.Tracer.span

    def recording(self, component, name, *a, **k):
        seen[(component, name)].add(threading.current_thread().name)
        return span(self, component, name, *a, **k)

    monkeypatch.setattr(ptracer.Tracer, "span", recording)
    return seen


@pytest.fixture(scope="module")
def measured_bundle():
    return pgt.build_trace(pgt.RunConfig(**MEASURED, device="cpu"))


class TestMeasured:
    def _cfg(self, **kw):
        return pgt.RunConfig(**dict(MEASURED, **kw), device="cpu",
                             mem_budget=MemoryBudget(device_payloads=True))

    def test_p1_reconciles_and_observes_only(self, measured_bundle):
        on = pgt.run(self._cfg(trace=True), measured_bundle)
        off = pgt.run(self._cfg(), measured_bundle)
        reconcile(on.trace)
        for name in ("step_hits", "step_misses", "fetched_rows_by_owner",
                     "window_per_epoch"):
            np.testing.assert_array_equal(getattr(on, name),
                                          getattr(off, name))
        assert on.compute_report["losses"] == off.compute_report["losses"]
        spans = _events(on.trace, "compute", "span")
        assert len(spans) == MEASURED["n_epochs"] * MEASURED["steps_per_epoch"]
        for s in spans:
            a = s["args"]
            assert a["roof_device"] == "cpu"
            assert not any(k.startswith("roof_") and k != "roof_device"
                           for k in a) and "bound" not in a
            assert a["flops_est"] == 2.0 * a["n_edges"] * (64 + 16)
            assert a["bytes_est"] == 2.0 * a["flops_est"]
            assert s["t1"] > s["t0"]

    def test_p4_reconciles(self):
        cfg = pgt.RunConfig(**dict(MEASURED, steps_per_epoch=3,
                                   scenario="clean", trace=True),
                            device="cpu",
                            mem_budget=MemoryBudget(device_payloads=True))
        rep = pcluster.run_cluster(
            cfg, pcluster.ClusterConfig(n_workers=4, link_rate_scale=HOT))
        totals = reconcile(rep.trace)
        assert sorted(totals) == [0, 1, 2, 3]
        assert all(t["components"]["collective"]["gpu_j"] > 0
                   for t in totals.values())
        assert all(s["args"]["roof_device"] == "cpu"
                   for s in _events(rep.trace, "compute", "span"))
        assert _events(rep.trace, "fabric", "span")

    def test_threaded_pipeline_spans(self, measured_bundle, monkeypatch):
        """A threaded run has each rebuild's plan and fetch spans (from
        the builder thread) and its exposed-wait and swap spans (from the
        consumer), and reconciles."""
        seen = _span_threads(monkeypatch)
        res = pgt.run(self._cfg(trace=True, async_pipeline=True),
                      measured_bundle)
        reconcile(res.trace)
        names = collections.Counter(
            e["name"] for e in _events(res.trace, "pipeline", "span"))
        n = res.pipeline.n_rebuilds
        assert n > 0
        assert names == {"plan": n, "fetch": n, "exposed-wait": n, "swap": n}
        assert seen[("pipeline", "plan")] == {"cache-builder"}
        assert seen[("pipeline", "fetch")] == {"cache-builder"}
        assert "cache-builder" not in seen[("pipeline", "swap")]
        charges = _events(res.trace, "rebuild", "charge")
        assert [e["name"] for e in charges] == ["rebuild-async"] * n


def test_budgeted_tier_counters(monkeypatch):
    """``ooc_community`` under a host budget of 0.3 of its matrix, traced:
    the payload is the reference's; each window has its ``tier-window``
    counter, and the counters' deltas sum to the tier counts at the last
    window's boundary (the last window's own steps come after it)."""
    graph = rds.materialize("ooc_community", seed=0)
    host = 0.3 * graph.n_nodes * graph.feature_source.n_feat * 4
    kw = dict(method="static_w", dataset="ooc_community", batch_size=600,
              n_epochs=2, steps_per_epoch=4, static_window=2, seed=1,
              scenario="clean", trace=True)
    snapshots = []
    counters = pworker.TrainerWorker._trace_tier_counters

    def snapshot(self, *a):
        counters(self, *a)
        snapshots.append(self.store.tier_stats.counts())

    monkeypatch.setattr(pworker.TrainerWorker, "_trace_tier_counters",
                        snapshot)
    ref = rgt.run(rgt.RunConfig(**kw, mem_budget=RefBudget(
        host_bytes=host, chunk_rows=256)))
    port = pgt.run(pgt.RunConfig(**kw, mem_budget=MemoryBudget(
        host_bytes=host, chunk_rows=256), device="cpu"))
    assert dumps_canonical(port.trace) == ref_dumps(ref.trace)
    reconcile(port.trace)
    counts = _events(port.trace, "store", "counter")
    windows = _events(port.trace, "window", "instant")
    assert len(counts) == len(windows) == len(snapshots) == 4
    total = collections.Counter()
    for c in counts:
        total.update({k: v for k, v in c["args"].items()
                      if k != "peak_resident_bytes"})
    last = dict(snapshots[-1])
    assert last.pop("peak_resident_bytes") \
        == counts[-1]["args"]["peak_resident_bytes"]
    assert dict(total) == {k: v for k, v in last.items() if v}
    assert total["block_fetches"] > 0
    for k, v in port.tier_counts.items():
        assert v >= last.get(k, 0)


# --------------------------------------------------------------- roofline
class TestRoofline:
    def test_h100_peaks(self):
        p = roofline.peaks_of(H100)
        assert (p.hbm_bytes_per_s, p.fp32_flop_per_s, p.bf16_flop_per_s) \
            == (3.35e12, 67e12, 989e12)
        comp, mem = p.terms(2.0e9, 4.0e9)
        assert comp == 2.0e9 / 67e12 and mem == 4.0e9 / 3.35e12
        assert p.terms(989e9, 0.0, "bf16") == (1e-3, 0.0)
        with pytest.raises(ValueError, match="dtype"):
            p.flop_per_s("int8")

    def test_unknown_card_raises(self):
        with pytest.raises(KeyError, match="no peaks"):
            roofline.peaks_of("NVIDIA A100-SXM4-80GB")

    def test_cpu_has_no_peaks(self):
        assert roofline.device_peaks("cpu") is None


def test_traced_worker_prices_at_card_peaks(monkeypatch):
    """On a card the measured span prices the per-edge estimate at the
    card's fp32 peaks (the card's name read through the table); here the
    lookup is pointed at the H100's entry and the step runs on the CPU."""
    monkeypatch.setattr(pworker, "device_peaks",
                        lambda device: roofline.peaks_of(H100))
    cfg = pgt.RunConfig(**dict(MEASURED, n_epochs=1, trace=True),
                        device="cpu")
    res = pgt.run(cfg)
    spans = _events(res.trace, "compute", "span")
    assert len(spans) == MEASURED["steps_per_epoch"]
    for s in spans:
        a = s["args"]
        assert a["roof_device"] == H100
        assert a["roof_compute_s"] == a["flops_est"] / 67e12
        assert a["roof_memory_s"] == a["bytes_est"] / 3.35e12
        assert a["bound"] == "memory"
    reconcile(res.trace)
