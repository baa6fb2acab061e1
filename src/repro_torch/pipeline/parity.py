"""Parity harness: threaded pipeline vs synchronous analytic path.

Port of ``repro/pipeline/parity.py``.

The threaded pipeline is only admissible if it is *semantically invisible*:
for the same presampled trace it must touch exactly the same cache states,
producing an identical per-step hit/miss stream and identical per-owner
remotely-fetched row counts. This holds by construction for deterministic
window schedules (e.g. ``static_w``) because

  * builds are serialized and each plan diffs against the hot set of the
    previous window (same diff base as the synchronous path),
  * the atomic generation-tagged swap happens at the same step boundary,
  * hit/miss classification stays on the consumer thread against the
    current active buffer (prefetch timing cannot perturb it).

``check_parity`` runs both paths on one shared trace bundle and compares.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ParityReport:
    ok: bool
    n_steps: int
    mismatched_steps: int          # positions where hit/miss streams differ
    sync_hits: int
    async_hits: int
    sync_fetched_rows: np.ndarray  # (n_owners,)
    async_fetched_rows: np.ndarray
    pipeline_summary: dict | None

    def describe(self) -> str:
        lines = [
            f"parity: {'OK' if self.ok else 'MISMATCH'}",
            f"  steps compared        : {self.n_steps}",
            f"  mismatched steps      : {self.mismatched_steps}",
            f"  hits (sync / async)   : {self.sync_hits} / {self.async_hits}",
            f"  fetched rows by owner : sync={self.sync_fetched_rows.astype(int).tolist()} "
            f"async={self.async_fetched_rows.astype(int).tolist()}",
        ]
        if self.pipeline_summary:
            lines.append(f"  pipeline              : {self.pipeline_summary}")
        return "\n".join(lines)


def check_parity(cfg, trace_bundle=None) -> ParityReport:
    """Run ``cfg`` through both execution paths and compare observables.

    ``cfg`` should use a deterministic window schedule (``static_w`` or any
    non-adaptive windowed method); adaptive controllers decide one boundary
    earlier on the threaded path, so their schedules can legitimately
    diverge and parity is not claimed.
    """
    from repro_torch.train import gnn_trainer as gt

    if trace_bundle is None:
        trace_bundle = gt.build_trace(cfg)
    sync = gt.run(dataclasses.replace(cfg, async_pipeline=False), trace_bundle)
    asyn = gt.run(dataclasses.replace(cfg, async_pipeline=True), trace_bundle)
    return compare_runs(sync, asyn)


def compare_runs(sync, asyn) -> ParityReport:
    """Compare two completed RunResults (sync vs threaded) for parity."""
    same_len = len(sync.step_hits) == len(asyn.step_hits)
    if same_len:
        mism = int(
            np.sum(
                (sync.step_hits != asyn.step_hits)
                | (sync.step_misses != asyn.step_misses)
            )
        )
    else:
        mism = abs(len(sync.step_hits) - len(asyn.step_hits))
    rows_equal = np.array_equal(
        sync.fetched_rows_by_owner, asyn.fetched_rows_by_owner
    )
    ok = bool(same_len and mism == 0 and rows_equal)
    return ParityReport(
        ok=ok,
        n_steps=len(sync.step_hits),
        mismatched_steps=mism,
        sync_hits=int(sync.step_hits.sum()),
        async_hits=int(asyn.step_hits.sum()),
        sync_fetched_rows=sync.fetched_rows_by_owner,
        async_fetched_rows=asyn.fetched_rows_by_owner,
        pipeline_summary=asyn.pipeline.summary() if asyn.pipeline else None,
    )
