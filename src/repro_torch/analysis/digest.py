"""Stable structural digests for bit-identity checks.

Port of ``repro/analysis/digest.py`` (numpy only), so the port's own
scripts can hold a run to a digest the reference pinned:

  * :func:`digest` — canonical sha256 over a nested structure (numpy
    arrays hash as ``dtype|shape|raw bytes``, floats as their IEEE-754
    bytes, dicts sort their keys, dataclasses hash their fields). Two
    objects digest equal iff they are bit-identical.
  * :func:`result_digest` / :func:`report_digest` — the canonical field
    selections for a trainer ``RunResult`` and a ``ClusterReport``, the
    same fields as the reference's, so the two packages' digests of
    equal runs are equal.
  * :func:`assert_results_equal` — field-wise bit-identity of two
    ``RunResult``s, naming the diverging field.
"""
from __future__ import annotations

import dataclasses
import hashlib
import struct

import numpy as np


def _update(h, obj) -> None:
    # tag every branch so containers can't collide with their contents
    if obj is None:
        h.update(b"N")
    elif isinstance(obj, bool):
        h.update(b"B" + (b"1" if obj else b"0"))
    elif isinstance(obj, int):
        b = str(obj).encode()
        h.update(b"I" + struct.pack("<q", len(b)) + b)
    elif isinstance(obj, float):
        h.update(b"F" + struct.pack("<d", obj))
    elif isinstance(obj, str):
        b = obj.encode()
        h.update(b"S" + struct.pack("<q", len(b)) + b)
    elif isinstance(obj, bytes):
        h.update(b"Y" + struct.pack("<q", len(obj)) + obj)
    elif isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        meta = f"{arr.dtype.str}|{arr.shape}".encode()
        h.update(b"A" + struct.pack("<q", len(meta)) + meta + arr.tobytes())
    elif isinstance(obj, (np.generic,)):
        _update(h, np.asarray(obj))
    elif isinstance(obj, dict):
        h.update(b"D" + struct.pack("<q", len(obj)))
        for k in sorted(obj, key=repr):
            _update(h, k)
            _update(h, obj[k])
    elif isinstance(obj, (list, tuple)):
        h.update(b"L" + struct.pack("<q", len(obj)))
        for item in obj:
            _update(h, item)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        h.update(b"C" + type(obj).__name__.encode())
        for f in dataclasses.fields(obj):
            _update(h, f.name)
            _update(h, getattr(obj, f.name))
    elif hasattr(obj, "__array__"):  # tensors on the CPU and friends
        _update(h, np.asarray(obj))
    else:
        raise TypeError(
            f"digest: unsupported type {type(obj).__name__!r}; convert to "
            "arrays/scalars/containers first"
        )


def digest(obj) -> str:
    """Canonical sha256 hex digest; equal iff ``obj`` is bit-identical."""
    h = hashlib.sha256()
    _update(h, obj)
    return h.hexdigest()


def combine(*digests: str) -> str:
    """One digest over several (order-sensitive)."""
    h = hashlib.sha256()
    for d in digests:
        h.update(d.encode())
    return h.hexdigest()


# --------------------------------------------------------------------------
# Canonical field selections for the repo's result objects
# --------------------------------------------------------------------------

def result_fields(result) -> dict:
    """The bit-identity surface of a trainer ``RunResult``.

    Everything here is a pure function of (config, seed) on the
    synchronous pipeline path — the same fields the cluster parity tests
    have asserted field-by-field since PR 4.
    """
    m = result.meter
    return {
        "gpu_j": float(m.gpu_j),
        "cpu_j": float(m.cpu_j),
        "wall_s": float(m.wall_s),
        "remote_bytes": float(m.remote_bytes),
        "n_rpcs": int(m.n_rpcs),
        "step_hits": np.asarray(result.step_hits),
        "step_misses": np.asarray(result.step_misses),
        "fetched_rows_by_owner": np.asarray(result.fetched_rows_by_owner),
        "sigma_trace": np.asarray(result.sigma_trace),
        "hit_rate_per_epoch": np.asarray(result.hit_rate_per_epoch),
        "window_per_epoch": np.asarray(result.window_per_epoch),
    }


def result_digest(result) -> str:
    return digest(result_fields(result))


# time-derived meter fields: real wall-clock enters them when the run
# used compute="measured", so the measured-lane determinism surface
# excludes exactly these
_ENERGY_FIELDS = ("gpu_j", "cpu_j", "wall_s")


def measured_result_fields(result) -> dict:
    """Deterministic surface of a ``compute="measured"`` run.

    Measured step times are real wall-clock, so every meter field they
    flow into (:data:`_ENERGY_FIELDS`) is excluded; what remains — the
    discrete hit/miss/byte streams plus the measured lane's own loss
    trajectory and step counts — must still be a pure function of
    (config, seed).
    """
    fields = result_fields(result)
    for name in _ENERGY_FIELDS:
        fields.pop(name)
    rep = getattr(result, "compute_report", None) or {}
    fields["compute_losses"] = np.asarray(
        rep.get("losses", ()), np.float64
    )
    fields["compute_steps"] = int(rep.get("n_steps", 0))
    fields["compute_edges"] = np.asarray(
        rep.get("step_edges", ()), np.int64
    )
    return fields


def measured_result_digest(result) -> str:
    return digest(measured_result_fields(result))


def report_digest(report) -> str:
    """Digest of a ``ClusterReport``'s deterministic surface."""
    return digest({
        "results": [result_fields(r) for r in report.results],
        "sync_wait_s": np.asarray(report.sync_wait_s),
        "sync_coll_s": np.asarray(report.sync_coll_s),
        "total_queue_s": float(report.total_queue_s),
        "methods": list(report.methods),
    })


def assert_results_equal(a, b) -> None:
    """Field-wise bit-identity of two ``RunResult``s (named failures)."""
    fa, fb = result_fields(a), result_fields(b)
    for name in fa:
        va, vb = fa[name], fb[name]
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f"field {name!r}")
        else:
            assert va == vb, f"field {name!r}: {va!r} != {vb!r}"
    assert result_digest(a) == result_digest(b)
