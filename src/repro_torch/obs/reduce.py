"""Shared telemetry reduction: one merge law for every per-rank counter dict.

Port of ``repro/obs/reduce.py``. Cumulative counters merge by element-wise
SUM, peak/watermark gauges by MAX; callers declare which keys are gauges.
Ratio/mean keys (hit rates, mean latencies, overlap efficiencies) merge by
neither law: callers recompute them from merged numerators and
denominators (``ClusterReport.pipeline_totals`` / ``requester_totals``).
"""
from __future__ import annotations


def merge_counters(counts, max_keys=()) -> dict | None:
    """Merge per-rank counter dicts: sum values, except ``max_keys`` which
    take the element-wise max (the merged figure of a per-rank gauge is
    the worst rank, not the sum).

    Falsy entries (``None``, ``{}``) are skipped; returns ``None`` when
    nothing is left to merge. Key order follows first appearance, so
    homogeneous inputs keep their key order (digest stability).
    """
    mx = frozenset(max_keys)
    live = [c for c in counts if c]
    if not live:
        return None
    out: dict = {}
    for c in live:
        for k, v in c.items():
            if k in mx:
                prev = out.get(k)
                out[k] = v if prev is None else max(prev, v)
            else:
                out[k] = out.get(k, 0) + v
    return out
