"""The port's event fabric, background processes, trace replay and
scenario registry against the JAX reference's ``repro.net``, on the CPU.

Both sides are numpy float64 with the same seeded RNG streams, so every
scenario's delta, utilization and sigma, and every transfer's timing,
must agree bit for bit.
"""
import csv
import json

import numpy as np
import pytest

from repro.core import cost_model as rcm
from repro.net import background as rbg
from repro.net import fabric as rfab
from repro.net import scenarios as rsc
from repro_torch.core import cost_model as pcm
from repro_torch.net import background as pbg
from repro_torch.net import fabric as pfab
from repro_torch.net import scenarios as psc
from repro_torch.net.trace_replay import load_trace
from _jax_release import release_jax_executables  # noqa: F401

RP, PP = rcm.CostModelParams(), pcm.CostModelParams()
SHAPE = dict(n_owners=3, seed=5, n_epochs=12, steps_per_epoch=16)

SPECS = [
    "clean", "paper_schedule", "bursty_markov", "diurnal", "incast",
    "straggler", "fixed:7.5", "fixed:0",
    "arch_none", "arch_slow", "arch_switch", "arch_two_sym",
    "arch_two_asym", "arch_osc",
]


def _write_traces(root):
    """One seeded delta-vs-time trace in the three on-disk layouts the
    loader reads: a JSON dict, a JSON record list, a CSV with a header."""
    rng = np.random.default_rng(9)
    t = np.concatenate([[0.0], np.cumsum(rng.uniform(0.01, 0.2, 29))])
    d = (rng.random((30, 3)) < 0.5) * rng.uniform(1.0, 25.0, (30, 3))
    paths = {}
    paths["dict"] = root / "delta.json"
    paths["dict"].write_text(json.dumps(
        {"time_s": t.tolist(), "delta_ms": d.tolist()}))
    paths["records"] = root / "records.json"
    paths["records"].write_text(json.dumps(
        [{"t": float(a), "delta": float(b[0])} for a, b in zip(t, d)]))
    paths["csv"] = root / "delta.csv"
    with open(paths["csv"], "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["t_s", "delta0", "delta1", "delta2"])
        for a, b in zip(t, d):
            w.writerow([a, *b])
    return {k: str(v) for k, v in paths.items()}


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    return _write_traces(tmp_path_factory.mktemp("traces"))


def _clocks():
    """Clocks over a run: steps in order with a growing virtual time, then
    jumps back and forth (the processes are query-order independent)."""
    rng = np.random.default_rng(1)
    t = np.cumsum(rng.uniform(0.0, 0.04, 200))
    out = [(float(t[i]), i, i // 16) for i in range(200)]
    out += [(float(x), int(s), int(s) // 16)
            for x, s in zip(rng.uniform(0, 9.0, 40), rng.integers(0, 400, 40))]
    return out


def _pair(spec, **kw):
    args = dict(SHAPE, **kw)
    return (rsc.build_scenario(spec, params=RP, **args),
            psc.build_scenario(spec, params=PP, **args))


def _assert_state_equal(ref, port, requester=None):
    for t_s, step, epoch in _clocks():
        rc, pc = rfab.NetClock(t_s, step, epoch), pfab.NetClock(t_s, step,
                                                                epoch)
        for name in ("delta_ms", "utilization", "sigma"):
            a = getattr(ref, name)(rc, requester=requester)
            b = getattr(port, name)(pc, requester=requester)
            assert b.dtype == a.dtype and b.tobytes() == a.tobytes(), \
                (name, t_s, step)


@pytest.mark.parametrize("spec", SPECS)
def test_scenario_state_bit_equal(spec):
    ref, port = _pair(spec)
    assert port.name == ref.name
    assert (port.shared_rate, port.discipline) \
        == (ref.shared_rate, ref.discipline)
    _assert_state_equal(ref, port)


@pytest.mark.parametrize("layout", ["dict", "records", "csv"])
def test_trace_scenario_bit_equal(traces, layout):
    ref, port = _pair(f"trace:{traces[layout]}")
    _assert_state_equal(ref, port)
    np.testing.assert_array_equal(port.delta_process.trace.values,
                                  ref.delta_process.trace.values)


@pytest.mark.parametrize("spec", ["bursty_markov", "diurnal", "straggler",
                                  "arch_switch", "incast"])
def test_cluster_topology_state_bit_equal(spec):
    """Requester-aware mode: processes sized per global link, each
    requester reading its own owner slots."""
    ref, port = _pair(spec, n_parts=4, n_requesters=3)
    for r in range(3):
        _assert_state_equal(ref, port, requester=r)


def test_registry_names_and_refusals(tmp_path):
    assert psc.ScenarioRegistry.names() == rsc.ScenarioRegistry.names()
    for spec, exc in (("no_such_scenario", KeyError),
                      ("nope:1", KeyError), ("closed_form", ValueError)):
        with pytest.raises(exc) as r:
            rsc.build_scenario(spec, params=RP, **SHAPE)
        with pytest.raises(exc) as p:
            psc.build_scenario(spec, params=PP, **SHAPE)
        assert str(p.value) == str(r.value)
    # the committed greentrace exports are not delta-vs-time traces: both
    # sides refuse them the same way
    for name in ("hot_owner", "clean"):
        spec = f"trace:results/traces/{name}.json"
        with pytest.raises(ValueError) as r:
            rsc.build_scenario(spec, params=RP, **SHAPE)
        with pytest.raises(ValueError) as p:
            psc.build_scenario(spec, params=PP, **SHAPE)
        assert str(p.value) == str(r.value)
    with pytest.raises(FileNotFoundError):
        load_trace(str(tmp_path / "missing.json"))
    bad = tmp_path / "bad.txt"
    bad.write_text("0,1\n")
    with pytest.raises(ValueError):
        load_trace(str(bad))


def test_queue_training_codes_equal():
    specs = ["clean", "closed_form", "fixed:10", "trace:x.json",
             "arch_osc", "incast", "bursty_markov"]
    for spec in specs:
        assert psc.queue_training_code(spec) == rsc.queue_training_code(spec)
    assert psc.queue_training_pool() == rsc.queue_training_pool()
    assert psc.queue_training_pool(specs) == rsc.queue_training_pool(specs)
    with pytest.raises(KeyError):
        psc.queue_training_code("hot_owner")


def _result_bytes(tr):
    return (tr.raw_s, tr.cpu_s, tr.nbytes, tr.n_rpcs,
            np.asarray(tr.per_owner_s).tobytes(), tr.queue_s)


def _fabrics(kind, n_requesters):
    """(reference, port) fabrics: the registry's incast (FIFO shared hop
    over bursts), a processor-sharing hop over Markov load with per-link
    rates and propagation, or the paper schedule."""
    cluster = dict(n_parts=4, n_requesters=n_requesters) \
        if n_requesters > 1 else {}
    if kind == "incast":
        return _pair("incast", **cluster)
    if kind == "paper_schedule":
        return _pair("paper_schedule", **cluster)
    n_links = 4 if cluster else 3
    out = []
    for fab, bg, params in ((rfab, rbg, RP), (pfab, pbg, PP)):
        out.append(fab.Fabric(
            params, 3,
            delta_process=bg.ConstantDelta([2.0, 0.0, 9.5, 1.0][:n_links]),
            load_process=bg.MarkovOnOffLoad(n_links, 0.05, 0.1, 0.8, seed=3),
            shared_rate=0.8 / params.beta,
            shared_load_process=bg.DiurnalLoad(0.3, 0.5, seed=4, n_links=1),
            discipline="ps", link_rate=[1 / params.beta, 0.5 / params.beta,
                                        2 / params.beta, 1 / params.beta
                                        ][:n_links],
            prop_delay_ms=[0.5, 0.0, 1.5, 0.25][:n_links], **cluster,
        ))
    return tuple(out)


@pytest.mark.parametrize("n_requesters", [1, 3])
@pytest.mark.parametrize("kind", ["incast", "ps_markov", "paper_schedule"])
def test_transfer_sequence_bit_equal(kind, n_requesters):
    """A seeded sequence of bulk and chunked transfers, some issued at a
    later ``at_s``, from every requester on its own clock: equal
    ``TransferResult``s, link and ingress backlogs, and per-requester
    metrics."""
    ref, port = _fabrics(kind, n_requesters)
    rng = np.random.default_rng(17 + n_requesters)
    t = np.zeros(n_requesters)
    for i in range(120):
        r = int(rng.integers(0, n_requesters))
        t[r] += float(rng.uniform(0.0, 0.02))
        rows = np.floor(rng.uniform(0, 3000, 3) * (rng.random(3) < 0.8))
        chunked = rng.random() < 0.4
        kw = dict(requester=r)
        if chunked:
            kw.update(chunk=int(rng.choice([64, 512])),
                      concurrency=int(rng.integers(1, 4)))
        if rng.random() < 0.3:
            kw["at_s"] = t[r] + float(rng.uniform(0, 0.01))
        if n_requesters > 1:
            rclk, pclk = rfab.NetClock(t[r], i, i // 16), \
                pfab.NetClock(t[r], i, i // 16)
        else:
            ref.tick(t[r], i, i // 16)
            port.tick(t[r], i, i // 16)
            rclk = pclk = None
        a = ref.transfer(rows, 400.0, clock=rclk, **kw)
        b = port.transfer(rows, 400.0, clock=pclk, **kw)
        assert _result_bytes(b) == _result_bytes(a), i
        assert port.free_at.tobytes() == ref.free_at.tobytes()
        assert port._shared_free_at.tobytes() == ref._shared_free_at.tobytes()
    assert port.requester_metrics() == ref.requester_metrics()
    assert (port.total_queue_s, port.n_transfers) \
        == (ref.total_queue_s, ref.n_transfers)
    assert port.total_queue_s > 0


def test_probe_rpc_and_owner_links_equal():
    for rows, delta, chunk in ((1000, 0.0, None), (5000, 12.5, None),
                               (5000, 3.0, 512), (1, 25.0, 64)):
        a = rfab.probe_rpc(RP, rows, delta, 400.0, n_owners=3, chunk=chunk,
                           concurrency=2)
        b = pfab.probe_rpc(PP, rows, delta, 400.0, n_owners=3, chunk=chunk,
                           concurrency=2)
        assert _result_bytes(b) == _result_bytes(a)
    for n_parts in (2, 4, 8):
        for r in range(n_parts):
            np.testing.assert_array_equal(pfab.owner_links(n_parts, r),
                                          rfab.owner_links(n_parts, r))
    with pytest.raises(ValueError):
        pfab.owner_links(4, 4)


def test_fabric_refusals_match():
    for kw in (dict(discipline="lifo"), dict(n_parts=3),
               dict(n_parts=4, n_requesters=5)):
        with pytest.raises(ValueError):
            rfab.Fabric(RP, 3, **kw)
        with pytest.raises(ValueError):
            pfab.Fabric(PP, 3, **kw)
    port = pfab.Fabric(PP, 3)
    with pytest.raises(ValueError):
        port.transfer(np.ones(4), 400.0)


@pytest.mark.parametrize("kw,chunk", [
    ({}, None),
    ({}, 64),
    (dict(shared_rate=2e6, discipline="fifo"), None),
    (dict(shared_rate=2e6, discipline="ps"), None),
], ids=["bulk", "chunked", "shared_fifo", "shared_ps"])
def test_set_tracer_spans_equal_reference(kw, chunk):
    """A registered tracer gets one span a transfer, with each owner
    link's queue, service and propagation times, equal to the
    reference's; an unregistered requester gets none."""
    from repro.obs import Tracer as RefTracer
    from repro_torch.obs import Tracer as PortTracer

    ref = rfab.Fabric(RP, 3, n_parts=4, n_requesters=4, **kw)
    port = pfab.Fabric(PP, 3, n_parts=4, n_requesters=4, **kw)
    rtr, ptr = RefTracer(rank=1, params=RP), PortTracer(rank=1, params=PP)
    ref.set_tracer(1, rtr)
    port.set_tracer(1, ptr)
    rows = np.array([300.0, 0.0, 120.0])
    for i, t in enumerate((0.0, 0.0001, 0.0002)):
        for requester in (1, 2):
            clock = pfab.NetClock(t, i, 0)
            rclock = rfab.NetClock(t, i, 0)
            a = port.transfer(rows, 400.0, chunk=chunk, requester=requester,
                              clock=clock)
            b = ref.transfer(rows, 400.0, chunk=chunk, requester=requester,
                             clock=rclock)
            assert a.raw_s == b.raw_s
    assert json.dumps(ptr.events, sort_keys=True) \
        == json.dumps(rtr.events, sort_keys=True)
    assert len(ptr.events) == 3
    for ev in ptr.events:
        assert ev["args"]["requester"] == 1
        assert [o["slot"] for o in ev["args"]["owners"]] == [0, 2]
        for o in ev["args"]["owners"]:
            assert o["finish_s"] >= o["start_s"] >= o["ready_s"]
    assert sum(o["queue_s"] for ev in ptr.events
               for o in ev["args"]["owners"]) > 0


def test_sanitized_transfer_asserts_the_lock():
    """With the sanitizer armed, the transfer body refuses to run unless
    the fabric's lock is held."""
    from repro_torch.analysis.runtime import SanitizerError

    fab = pfab.Fabric(PP, 3, sanitize=True)
    fab.transfer(np.ones(3), 400.0)   # through transfer(): the lock is held
    with pytest.raises(SanitizerError):
        fab._transfer_locked(np.ones(3), np.ones(3, bool), np.arange(3),
                             400.0, None, None, 1, 0, None)
