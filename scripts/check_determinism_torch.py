"""Numeric half of the port's greendrift: the ``dynamic`` twins, run.

    PYTHONPATH=src python scripts/check_determinism_torch.py twins

Every ``dynamic``-kind twin in ``repro_torch.analysis.drift.registry`` —
pairings whose sides are intentionally different shapes, so the static
canonicalizer cannot compare them — is run on matched inputs and held
bitwise or within a stated tolerance, on the CPU (the compute law's
plumbing half times the CPU path with a virtual clock; the card's path
times with CUDA events and is held by ``chip_smoke.py``). The target
REFUSES to pass if a registered dynamic twin has no runner here (or a
runner has no registry entry), so retiring either side of the contract
alone fails. Exit code 0 when every twin agrees, 1 otherwise.

The reference's other targets (``trainer``, ``cluster``, ``store``,
``compute``, ``trace`` in ``scripts/check_determinism.py``) pair
same-seed runs; the port's same-seed pairs are held by its tests
(``tests/test_torch_trainer.py``, ``test_torch_cluster.py``,
``test_torch_store.py``, ``test_torch_obs.py``, ...), not here.
"""
from __future__ import annotations

import argparse
import sys


def _twin_report(name: str, ok: bool, detail: str = "") -> bool:
    status = "OK " if ok else "FAIL"
    print(f"[twins] {status} {name}" + (f": {detail}" if detail else ""))
    return ok


def _twin_fabric_rpc_wall() -> bool:
    """One isolated clean-fabric transfer == the Eq. 4 closed form."""
    from repro_torch.core import cost_model as cm
    from repro_torch.net.fabric import probe_rpc

    params = cm.CostModelParams()
    worst = 0.0
    for rows in (64.0, 1024.0, 16384.0):
        for d in (0.0, 5.0, 20.0):
            tr = probe_rpc(params, rows, d, 400.0)
            want = cm.rpc_wall_s(
                float(params.alpha_rpc), float(params.beta),
                float(params.gamma_c), rows * 400.0, d,
            )
            worst = max(worst, abs(tr.raw_s - want) / max(abs(want), 1e-12))
    return _twin_report(
        "fabric-rpc-wall", worst <= 1e-9, f"max rel err {worst:.2e}"
    )


def _twin_sigma_law() -> bool:
    """Fabric-reported sigma at u=0 == 1 + (gamma_c/beta) * delta (the
    closed form in float32, the fabric in float64)."""
    import numpy as np

    from repro_torch.core import cost_model as cm
    from repro_torch.net.background import ConstantDelta
    from repro_torch.net.fabric import Fabric

    params = cm.CostModelParams()
    worst = 0.0
    for d in (0.0, 2.0, 10.0):
        fabric = Fabric(
            params, 3, delta_process=ConstantDelta(d), name="twin-sigma"
        )
        got = np.asarray(fabric.sigma())
        want = float(cm.sigma_from_delta(params, d))
        worst = max(worst, float(np.max(np.abs(got - want))))
    return _twin_report(
        "sigma-law", worst <= 1e-6, f"max abs err {worst:.2e}"
    )


def _twin_store_headroom() -> bool:
    """Fluid W-headroom == tiered-store byte accounting at block-aligned
    residency (budget = frac of the feature bytes, working set = the
    W/MAX_WINDOW fraction of the rows)."""
    import types

    import numpy as np
    import torch

    from repro_torch.core import queue_sim as qs
    from repro_torch.store import MemoryBudget
    from repro_torch.store.tiered import TieredFeatureStore

    chunk = 32
    n_rows = int(qs.MAX_WINDOW) * chunk
    feat = np.zeros((n_rows, 4), np.float32)
    owner_of = np.zeros(n_rows, np.int64)
    frac = 0.5
    cfg = types.SimpleNamespace(mem_budget_frac=frac)
    worst = 0.0
    for w in (8, 16, 32):
        budget = MemoryBudget(
            host_bytes=frac * n_rows * feat.itemsize * feat.shape[1],
            chunk_rows=chunk,
        )
        store = TieredFeatureStore(feat, owner_of, 0, 2, budget=budget)
        store.touch(np.arange(w * chunk))      # exactly w resident blocks
        got = store.headroom()
        want = float(qs.mem_headroom(cfg, torch.tensor([float(w)]))[0])
        worst = max(worst, abs(got - want))
    return _twin_report(
        "store-headroom", worst <= 1e-9, f"max abs err {worst:.2e}"
    )


def _twin_store_spill() -> bool:
    """No-overflow endpoint: the fluid spill multiplier is exactly 1.0
    iff re-touching the working set under a matching block budget fetches
    nothing (and > 1.0 iff the CLOCK tier thrashes)."""
    import types

    import numpy as np
    import torch

    from repro_torch.core import queue_sim as qs
    from repro_torch.store.host_tier import HostTier

    chunk = 32
    frac = 0.5
    budget_blocks = int(frac * int(qs.MAX_WINDOW))
    cfg = types.SimpleNamespace(mem_budget_frac=frac)
    ok = True
    for w in (16, 48, 64, 96, 120):
        spill = float(qs.mem_spill(cfg, torch.tensor([float(w)]))[0])
        tier = HostTier(int(qs.MAX_WINDOW) * chunk, chunk, budget_blocks)
        rows = np.arange(w * chunk)
        tier.touch(rows)
        refetched = len(tier.touch(rows))      # steady-state thrash
        ok &= (spill == 1.0) == (refetched == 0)
        ok &= spill >= 1.0
    return _twin_report("store-spill", ok)


def _twin_delta_np() -> bool:
    """Full-profile delta_at (batched float32 tensors) == delta_at_np
    (float64, one profile), including the `sev` fragment the law twins
    exclude. float32 sin vs float64 sin on large phase arguments bounds
    the tolerance."""
    import numpy as np
    import torch

    from repro_torch.core import domain_rand as dr

    worst = 0.0
    for n_owners in (1, 3, 7):
        gen = torch.Generator().manual_seed(n_owners)
        prof = dr.sample_profile(gen, 512, n_owners, n=4)
        for step in (0.0, 10.0, 100.0, 300.0, 511.0):
            a = dr.delta_at(prof, step, n_owners).numpy()
            for i in range(4):
                b = dr.delta_at_np(
                    int(prof.archetype[i]), float(prof.severity_ms[i]),
                    float(prof.onset[i]), float(prof.duration[i]),
                    float(prof.period[i]), int(prof.link_a[i]),
                    int(prof.link_b[i]), float(prof.phase[i]), step,
                    n_owners,
                )
                worst = max(worst, float(np.max(np.abs(a[i] - b))))
    return _twin_report(
        "delta-np-numeric", worst <= 5e-3, f"max abs err {worst:.2e} ms"
    )


def _twin_paper_schedule() -> bool:
    """The schedule's three forms over every epoch and odd cluster sizes:
    the tensor form bit-equal to the float32 host form, the float64 twin
    within float32 rounding."""
    import numpy as np
    import torch

    from repro_torch.core import domain_rand as dr

    n_epochs = 12
    worst = 0.0
    tensor_equal = True
    epochs = torch.arange(n_epochs)
    for n_owners in (1, 3, 7):
        t = dr.paper_schedule_delta_t(epochs, n_epochs, n_owners).numpy()
        for epoch in range(n_epochs):
            a = dr.paper_schedule_delta(epoch, n_epochs, n_owners)
            b = dr.paper_schedule_delta_np(epoch, n_epochs, n_owners)
            worst = max(worst, float(np.max(np.abs(a - b))))
            tensor_equal &= bool(np.array_equal(t[epoch], a))
    return _twin_report(
        "paper-schedule-numeric", worst <= 1e-5 and tensor_equal,
        f"max abs err {worst:.2e}, tensor form bit-equal: {tensor_equal}",
    )


def _twin_collective() -> bool:
    """The cluster env's tensor ``ring_collective_t`` ==
    ``ring_collective_cost`` at every live-peer count (float32 against
    the host's float64)."""
    import types

    import torch

    from repro_torch.core import cost_model as cm
    from repro_torch.distributed.collectives import ring_collective_cost
    from repro_torch.envs.cluster_sim import ring_collective_t

    p = cm.CostModelParams()
    params = types.SimpleNamespace(
        alpha_rpc=torch.tensor([p.alpha_rpc] * 3, dtype=torch.float32),
        beta=torch.tensor([p.beta] * 3, dtype=torch.float32),
    )
    n_live = torch.tensor([1.0, 3.0, 7.0])       # 2, 4, 8 ranks
    worst = 0.0
    for scatter in (False, True):
        cfg = types.SimpleNamespace(
            sync="reduce_scatter" if scatter else "ring", grad_bytes=2.0e6,
        )
        wall, cpu = ring_collective_t(cfg, params, n_live)
        for i, n in enumerate((2, 4, 8)):
            want_wall, want_cpu, _, _ = ring_collective_cost(
                n, cfg.grad_bytes, p, scatter=scatter
            )
            worst = max(
                worst,
                abs(float(wall[i]) - want_wall) / max(want_wall, 1e-12),
                abs(float(cpu[i]) - want_cpu) / max(want_cpu, 1e-12),
            )
    return _twin_report(
        "collective-numeric", worst <= 1e-5, f"max rel err {worst:.2e}"
    )


def _twin_compute_law() -> bool:
    """Measured lane -> ``calibrate_compute`` -> t_base round trip.

    Law recovery: synthetic samples generated FROM
    ``cost_model.compute_step_s`` must be fit back to the same (t0,
    per_edge) and to a t_base that equals the law at the mean edge count.
    Plumbing: a CPU ``ComputeEngine`` on a virtual clock that advances a
    fixed dt per read measures exactly dt for every step (the untimed
    first run of a shape reads the clock into ``compile_s`` only), so
    calibrating on ``engine.calibration_samples()`` recovers t_base == dt.
    """
    import numpy as np

    from repro_torch.core import calibration as cal
    from repro_torch.core import cost_model as cm
    from repro_torch.train import gnn_trainer as gt
    from repro_torch.train.compute import ComputeEngine

    t0, per_edge = 2.5e-3, 7.5e-8
    edges = np.array([1.0e3, 5.0e3, 2.0e4, 1.0e5])
    times = np.asarray(
        [cm.compute_step_s(t0, per_edge, float(e)) for e in edges]
    )
    params, fit = cal.calibrate_compute(edges, times)
    want_tb = float(cm.compute_step_s(t0, per_edge, float(edges.mean())))
    worst = max(
        abs(fit.t0 - t0) / t0,
        abs(fit.per_edge - per_edge) / per_edge,
        abs(float(params.t_base) - want_tb) / want_tb,
    )

    # the virtual clock makes the steps' times independent of the graph:
    # the smallest bench graph, at build_trace's least batch (32 seeds)
    cfg = gt.RunConfig(
        method="static_w", dataset="full_graph_sm", batch_size=320,
        n_epochs=1, steps_per_epoch=3, scenario="clean",
        compute="measured", device="cpu",
    )
    graph, _owner, _traces, mbs = gt.build_trace(cfg)

    class _VClock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            self.t += 1e-3
            return self.t

    dt = 1e-3
    eng = ComputeEngine(graph, cfg, clock=_VClock())
    for s in range(cfg.steps_per_epoch):
        mb = mbs[0][s]
        eng.step(
            mb, np.asarray(graph.features[mb.input_nodes], np.float32),
            key=(0, s),
        )
    e_s, t_s = eng.calibration_samples()
    p2, _fit2 = cal.calibrate_compute(e_s, t_s)
    worst = max(worst, abs(float(p2.t_base) - dt) / dt)
    return _twin_report(
        "compute-law-numeric", worst <= 1e-6, f"max rel err {worst:.2e}"
    )


_TWIN_RUNNERS = {
    "fabric-rpc-wall": _twin_fabric_rpc_wall,
    "sigma-law": _twin_sigma_law,
    "store-headroom": _twin_store_headroom,
    "store-spill": _twin_store_spill,
    "delta-np-numeric": _twin_delta_np,
    "paper-schedule-numeric": _twin_paper_schedule,
    "collective-numeric": _twin_collective,
    "compute-law-numeric": _twin_compute_law,
}


def check_twins() -> bool:
    """Run every registered dynamic twin; coverage itself is asserted."""
    from repro_torch.analysis.drift.registry import dynamic_twins

    registered = [t.name for t in dynamic_twins()]
    ok = True
    for twin in dynamic_twins():
        runner = _TWIN_RUNNERS.get(twin.name)
        if runner is None:
            ok = _twin_report(
                twin.name, False,
                "registered dynamic twin has no numeric runner — add one "
                "to _TWIN_RUNNERS or retire the registry entry",
            ) and ok
            continue
        ok = runner() and ok
    for name in _TWIN_RUNNERS:
        if name not in registered:
            ok = _twin_report(
                name, False,
                "runner has no registry entry — register the twin in "
                "repro_torch.analysis.drift.registry or delete the runner",
            ) and ok
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("target", choices=("twins",))
    p.parse_args(argv)
    return 0 if check_twins() else 1


if __name__ == "__main__":
    sys.exit(main())
