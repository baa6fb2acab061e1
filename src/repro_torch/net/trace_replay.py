"""Load measured delta-vs-time traces for fabric replay.

Port of ``repro/net/trace_replay.py`` (copied).

Two on-disk formats are accepted (selected by extension):

  * JSON — either ``{"time_s": [...], "delta_ms": [[per-owner ...], ...]}``
    or a list of records ``[{"t": 0.0, "delta": [...]}, ...]`` (``time_s``/
    ``t`` and ``delta_ms``/``delta`` are interchangeable; a scalar delta
    applies to every owner);
  * CSV — header ``t_s,delta0,delta1,...`` (or headerless numeric rows in
    the same column order).

Replay is piecewise-constant (a step function over the sample times, the
natural interpretation of polled telemetry). Queries before the first
sample return the first value; queries past the end hold the last value,
or wrap when ``loop=True``.
"""
from __future__ import annotations

import csv
import json
import os

import numpy as np


class DeltaTrace:
    """Piecewise-constant per-owner delta(t) [ms]."""

    def __init__(self, time_s: np.ndarray, delta_ms: np.ndarray,
                 loop: bool = False, source: str = "<memory>"):
        time_s = np.asarray(time_s, np.float64).ravel()
        delta_ms = np.atleast_2d(np.asarray(delta_ms, np.float64))
        if delta_ms.shape[0] != time_s.shape[0]:
            delta_ms = delta_ms.T
        if delta_ms.shape[0] != time_s.shape[0]:
            raise ValueError(
                f"trace shape mismatch: {time_s.shape[0]} times vs "
                f"{delta_ms.shape} delta rows ({source})"
            )
        if time_s.size == 0:
            raise ValueError(f"empty trace: {source}")
        order = np.argsort(time_s, kind="stable")
        self.time_s = time_s[order]
        self.values = delta_ms[order]
        self.loop = bool(loop)
        self.source = source

    @property
    def duration_s(self) -> float:
        return float(self.time_s[-1])

    def delta_ms(self, t_s: float, n_owners: int) -> np.ndarray:
        t = float(t_s)
        if self.loop and self.duration_s > 0:
            t = t % self.duration_s
        idx = int(np.searchsorted(self.time_s, t, side="right")) - 1
        idx = min(max(idx, 0), len(self.time_s) - 1)
        row = self.values[idx]
        if row.size == 1:
            return np.full(n_owners, row[0])
        if row.size < n_owners:
            out = np.zeros(n_owners)
            out[: row.size] = row
            return out
        return row[:n_owners].copy()


def load_trace(path: str, loop: bool = False) -> DeltaTrace:
    """Load a JSON/CSV delta-vs-time file into a :class:`DeltaTrace`."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"congestion trace not found: {path}")
    ext = os.path.splitext(path)[1].lower()
    if ext == ".json":
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            times = data.get("time_s", data.get("t"))
            deltas = data.get("delta_ms", data.get("delta"))
            if times is None or deltas is None:
                raise ValueError(
                    f"JSON trace {path} needs 'time_s'/'t' and "
                    f"'delta_ms'/'delta' keys"
                )
        elif isinstance(data, list):
            times = [rec.get("time_s", rec.get("t")) for rec in data]
            deltas = [rec.get("delta_ms", rec.get("delta")) for rec in data]
        else:
            raise ValueError(f"unsupported JSON trace layout in {path}")
        deltas = np.vstack(
            [np.atleast_1d(np.asarray(d, np.float64)) for d in deltas]
        )
        return DeltaTrace(np.asarray(times), deltas, loop=loop, source=path)
    if ext == ".csv":
        rows = []
        with open(path, newline="") as f:
            for rec in csv.reader(f):
                if not rec:
                    continue
                try:
                    rows.append([float(x) for x in rec])
                except ValueError:
                    continue  # header line
        if not rows:
            raise ValueError(f"no numeric rows in CSV trace {path}")
        arr = np.asarray(rows, np.float64)
        if arr.shape[1] < 2:
            raise ValueError(
                f"CSV trace {path} needs t_s plus >=1 delta column"
            )
        return DeltaTrace(arr[:, 0], arr[:, 1:], loop=loop, source=path)
    raise ValueError(f"unsupported trace format {ext!r} for {path}")
