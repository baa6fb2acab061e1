"""Trace analyzer: "where did the joules go".

Port of ``repro/obs/report.py``.

Two complementary views of a greentrace payload:

* The **ledger** (charge events) sums bit-exactly to the meter totals
  (:func:`repro_torch.obs.tracer.reconcile`) — that is the auditable
  invariant.
* The **attribution** view here is a time-x-power decomposition for humans:
  each traced second is priced at the power draw the meter charges for that
  phase (active for compute, idle+base for waits, RPC power for CPU comm).
  Wire time is attributed per owner link (queue / service / propagation)
  even when pipeline slack hides it from the critical path — the energy is
  burned either way (paper Section II-A), which is exactly what makes the
  hot-owner diff visible. Attribution categories may therefore overlap the
  exposed-stall seconds; only the ledger is claimed to sum to the meter.
"""
from __future__ import annotations

from repro_torch.obs.tracer import KIND_CHARGE, KIND_SPAN, reconcile


def _powers(payload: dict) -> tuple[float, float, float]:
    p = payload["meta"]["params"]
    active = p["p_gpu_active"] + p["p_cpu_base"]
    wait = p["p_gpu_idle"] + p["p_cpu_base"]
    return active, wait, p["p_cpu_rpc"]


def attribution(payload: dict) -> dict:
    """Joules per attribution key across all ranks (time x power view)."""
    active_w, wait_w, rpc_w = _powers(payload)
    out: dict = {}

    def add(key: str, joules: float) -> None:
        if joules:
            out[key] = out.get(key, 0.0) + joules

    for sec in payload["ranks"]:
        for ev in sec["events"]:
            a = ev.get("args", {})
            if ev["kind"] == KIND_CHARGE:
                add("cpu-comm", a.get("cpu_comm_s", 0.0) * rpc_w)
                if ev["component"] == "collective":
                    add("barrier-wait", a.get("wait_s", 0.0) * wait_w)
                    add("collective", a.get("coll_s", 0.0) * wait_w)
                elif ev["component"] == "epoch-cache":
                    add("epoch-cache", a.get("stall_s", 0.0) * wait_w)
                else:
                    add("compute", a.get("compute_s", 0.0) * active_w)
                    add("rebuild-exposed", a.get("rebuild_s", 0.0) * wait_w)
                    add("ar-penalty", a.get("ar_s", 0.0) * wait_w)
            elif ev["kind"] == KIND_SPAN and ev["component"] == "fabric":
                for o in a.get("owners", ()):
                    lnk = o["link"]
                    add(f"link{lnk}/queue", o["queue_s"] * wait_w)
                    add(f"link{lnk}/service", o["service_s"] * wait_w)
                    add(f"link{lnk}/prop", o["prop_s"] * wait_w)
    return out


def top_spans(payload: dict, k: int = 10) -> list[dict]:
    """Top-k energy spans by (rank, owner, window, component).

    Charge events report their exact ledger joules; fabric transfer spans
    report per-owner attributed joules (wait power x wire time)."""
    _, wait_w, _ = _powers(payload)
    rows = []
    for sec in payload["ranks"]:
        for ev in sec["events"]:
            if ev["kind"] == KIND_CHARGE:
                rows.append({
                    "rank": ev["rank"], "owner": None,
                    "window": ev["window"], "component": ev["component"],
                    "name": ev["name"], "t0": ev["t0"],
                    "joules": ev["gpu_j"] + ev["cpu_j"],
                })
            elif ev["kind"] == KIND_SPAN and ev["component"] == "fabric":
                for o in ev.get("args", {}).get("owners", ()):
                    wire = o["queue_s"] + o["service_s"] + o["prop_s"]
                    rows.append({
                        "rank": ev["rank"], "owner": o["link"],
                        "window": ev["window"], "component": "fabric",
                        "name": f"link{o['link']}", "t0": ev["t0"],
                        "joules": wire * wait_w,
                    })
    rows.sort(key=lambda r: (-r["joules"], r["t0"], r["rank"]))
    return rows[:k]


def waterfall(payload: dict) -> list[dict]:
    """Per-window seconds: fetch / stall-exposed / rebuild-exposed /
    collective / compute, summed across ranks (windows are per-rank
    ordinals; ordinal i aggregates every rank's i-th window)."""
    buckets: dict = {}
    for sec in payload["ranks"]:
        for ev in sec["events"]:
            if ev["kind"] != KIND_CHARGE:
                continue
            a = ev.get("args", {})
            b = buckets.setdefault(ev["window"], {
                "window": ev["window"], "fetch_s": 0.0, "stall_s": 0.0,
                "rebuild_s": 0.0, "collective_s": 0.0, "compute_s": 0.0,
            })
            if ev["component"] == "collective":
                b["collective_s"] += a.get("stall_s", 0.0)
            else:
                b["fetch_s"] += a.get("fetch_s", 0.0)
                b["stall_s"] += a.get("exposed_s", a.get("stall_s", 0.0))
                b["rebuild_s"] += a.get("rebuild_s", 0.0)
                b["compute_s"] += a.get("compute_s", 0.0)
    return [buckets[w] for w in sorted(buckets)]


def diff(a: dict, b: dict) -> list[dict]:
    """Rank attribution keys by absolute energy movement between two traces
    (positive delta = more joules in ``b``)."""
    ja, jb = attribution(a), attribution(b)
    rows = [
        {"key": k, "a_j": ja.get(k, 0.0), "b_j": jb.get(k, 0.0),
         "delta_j": jb.get(k, 0.0) - ja.get(k, 0.0)}
        for k in sorted(set(ja) | set(jb))
    ]
    rows.sort(key=lambda r: (-abs(r["delta_j"]), r["key"]))
    return rows


# ---- terminal rendering ---------------------------------------------------
def format_report(payload: dict, k: int = 10) -> str:
    meta = payload["meta"]
    lines = [
        f"greentrace {meta['scenario']} · {meta['method']} · "
        f"P={meta['n_workers']} · seed={meta['seed']}",
    ]
    totals = reconcile(payload)  # raises if the ledger is broken
    for rank in sorted(totals):
        t = totals[rank]
        comps = " ".join(
            f"{c}={row['gpu_j'] + row['cpu_j']:.1f}J"
            for c, row in sorted(t["components"].items())
        )
        lines.append(
            f"  rank {rank}: gpu={t['gpu_j']:.1f}J cpu={t['cpu_j']:.1f}J "
            f"(reconciled bit-exact) · {comps}"
        )
    lines.append(f"-- top {k} energy spans (rank, owner, window, component)")
    for r in top_spans(payload, k):
        owner = "-" if r["owner"] is None else f"link{r['owner']}"
        lines.append(
            f"  {r['joules']:9.3f} J  rank={r['rank']} owner={owner} "
            f"window={r['window']} {r['component']}:{r['name']} "
            f"@t={r['t0']:.3f}s"
        )
    lines.append("-- attribution (time x power view)")
    att = attribution(payload)
    for key in sorted(att, key=lambda x: -att[x]):
        lines.append(f"  {att[key]:9.3f} J  {key}")
    lines.append("-- per-window waterfall (s, summed over ranks)")
    lines.append(
        "  win    fetch    stall  rebuild     coll  compute"
    )
    for b in waterfall(payload):
        lines.append(
            f"  {b['window']:3d} {b['fetch_s']:8.3f} {b['stall_s']:8.3f} "
            f"{b['rebuild_s']:8.3f} {b['collective_s']:8.3f} "
            f"{b['compute_s']:8.3f}"
        )
    return "\n".join(lines)


def format_diff(a: dict, b: dict, k: int = 10) -> str:
    la = a["meta"]["scenario"]
    lb = b["meta"]["scenario"]
    lines = [f"greentrace diff: {la} -> {lb} (top {k} energy movers)"]
    for r in diff(a, b)[:k]:
        lines.append(
            f"  {r['delta_j']:+10.3f} J  {r['key']}"
            f"  ({la}={r['a_j']:.3f} J, {lb}={r['b_j']:.3f} J)"
        )
    return "\n".join(lines)
