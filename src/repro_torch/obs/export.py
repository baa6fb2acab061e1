"""Trace payload assembly + canonical JSON + Perfetto/Chrome export.

Port of ``repro/obs/export.py``.

Canonical form: ``json.dumps(sort_keys=True, separators=(",", ":"))``.
Python's float repr round-trips exactly, so two bit-identical payloads
serialize to byte-identical files — the determinism harness digests the
canonical bytes directly.

The Chrome ``trace_event`` export opens in Perfetto (ui.perfetto.dev) or
``chrome://tracing``: one process per rank (charge/span events on the rank's
main thread track), owner links and the rebuild pipeline as async lanes,
store tier counters as counter tracks. Timestamps are virtual microseconds.
"""
from __future__ import annotations

import hashlib
import json
import pathlib

from repro_torch.obs.tracer import (
    KIND_CHARGE,
    KIND_COUNTER,
    KIND_INSTANT,
    SCHEMA,
)

_US = 1e6  # virtual seconds -> trace_event microseconds


def build_payload(sections, *, meta: dict) -> dict:
    """Assemble the run-level trace from per-rank tracer sections."""
    return {
        "schema": SCHEMA,
        "meta": meta,
        "ranks": sorted(
            [s for s in sections if s is not None], key=lambda s: s["rank"]
        ),
    }


def run_meta(cfg, *, scenario: str, n_workers: int) -> dict:
    """Trace metadata: enough config + power constants to re-verify the
    ledger and label the report without the original RunConfig."""
    p = cfg.params
    return {
        "method": cfg.method,
        "dataset": cfg.dataset,
        "scenario": scenario,
        "seed": int(cfg.seed),
        "n_workers": int(n_workers),
        "n_parts": int(cfg.n_parts),
        "n_epochs": int(cfg.n_epochs),
        "steps_per_epoch": int(cfg.steps_per_epoch),
        "params": {
            "p_gpu_active": float(p.p_gpu_active),
            "p_gpu_idle": float(p.p_gpu_idle),
            "p_cpu_base": float(p.p_cpu_base),
            "p_cpu_rpc": float(p.p_cpu_rpc),
            "t_base": float(p.t_base),
        },
    }


# ---- canonical JSON -------------------------------------------------------
def dumps_canonical(payload: dict) -> str:
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


def trace_digest(payload: dict) -> str:
    """SHA-256 over the canonicalized event stream (byte-determinism gate)."""
    return hashlib.sha256(dumps_canonical(payload).encode()).hexdigest()


def write_trace(path, payload: dict) -> pathlib.Path:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(dumps_canonical(payload) + "\n")
    return path


def load_trace(path) -> dict:
    payload = json.loads(pathlib.Path(path).read_text())
    if payload.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: schema {payload.get('schema')!r} != {SCHEMA!r}"
        )
    return payload


# ---- Chrome trace_event ---------------------------------------------------
def to_chrome(payload: dict) -> dict:
    """Convert a greentrace payload to Chrome ``trace_event`` JSON."""
    out = []
    for sec in payload["ranks"]:
        rank = sec["rank"]
        pid = rank
        out.append({
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": f"rank {rank}"},
        })
        out.append({
            "ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
            "args": {"name": "train (virtual time)"},
        })
        seq = 0
        for ev in sec["events"]:
            seq += 1
            base = {
                "pid": pid,
                "cat": ev["component"],
                "name": f"{ev['component']}:{ev['name']}",
                "ts": ev["t0"] * _US,
                "args": dict(ev.get("args", {})),
            }
            base["args"]["window"] = ev["window"]
            base["args"]["step"] = ev["step"]
            kind = ev["kind"]
            if kind == KIND_COUNTER:
                out.append({**base, "ph": "C", "tid": 0,
                            "name": f"{ev['component']}:{ev['name']}"})
            elif kind == KIND_INSTANT:
                out.append({**base, "ph": "i", "tid": 0, "s": "t"})
            elif ev["component"] == "fabric":
                # owner links as async lanes: one id per (rank, link), with
                # the queue/service/prop decomposition as nested slices
                _chrome_transfer(out, base, ev, seq)
            elif ev["component"] == "pipeline":
                out.append({**base, "ph": "b", "tid": 0, "id": seq,
                            "scope": "pipeline"})
                out.append({"ph": "e", "pid": pid, "tid": 0, "id": seq,
                            "scope": "pipeline", "cat": base["cat"],
                            "name": base["name"],
                            "ts": ev["t1"] * _US, "args": {}})
            else:
                dur = max(ev["t1"] - ev["t0"], 0.0) * _US
                if kind == KIND_CHARGE:
                    base["args"]["gpu_j"] = ev["gpu_j"]
                    base["args"]["cpu_j"] = ev["cpu_j"]
                out.append({**base, "ph": "X", "tid": 0, "dur": dur})
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"schema": payload["schema"],
                          "meta": payload["meta"]}}


def _chrome_transfer(out, base, ev, seq) -> None:
    pid = base["pid"]
    for o in ev.get("args", {}).get("owners", ()):
        aid = f"link{o['link']}"
        cat = "owner-link"
        for name, lo, hi in (
            ("queue", o["ready_s"], o["start_s"]),
            ("service", o["start_s"], o["finish_s"]),
            ("prop", o["finish_s"], o["finish_s"] + o["prop_s"]),
        ):
            if hi <= lo:
                continue
            out.append({
                "ph": "b", "pid": pid, "tid": 0, "cat": cat, "id": seq,
                "scope": aid, "name": f"{aid}:{name}", "ts": lo * _US,
                "args": {"bytes": o.get("bytes", 0.0)},
            })
            out.append({
                "ph": "e", "pid": pid, "tid": 0, "cat": cat, "id": seq,
                "scope": aid, "name": f"{aid}:{name}", "ts": hi * _US,
                "args": {},
            })


def write_chrome(path, payload: dict) -> pathlib.Path:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(to_chrome(payload), sort_keys=True) + "\n")
    return path
