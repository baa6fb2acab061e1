"""Energy accounting (paper Section VI "Measurement" + Table I breakdown).

The paper samples NVML (GPU) and RAPL (CPU) at every training step and
reports GPU / CPU / total energy summed over all nodes for a 30-epoch run.
Without hardware counters, the meter integrates the same quantities from the
calibrated power model over measured (or modeled) per-phase times:

  GPU energy = P_gpu_active * t_compute + P_gpu_idle * t_stall
  CPU energy = P_cpu_base * t_total + P_cpu_rpc_extra * t_comm

which reproduces the paper's structure: caching methods differ slightly in
GPU energy (both remove most idle time) but strongly in CPU energy (fewer /
cheaper remote fetches), cf. Section VI-B.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cost_model import CostModelParams


@dataclasses.dataclass
class StepSample:
    t_compute: float
    t_stall: float             # wall-clock stall on the critical path
    t_cpu_comm: float = 0.0    # CPU time spent on RPC processing (may exceed
                               # the stall when prefetch threads hide latency
                               # — energy is burned either way, Section II-A)
    remote_bytes: float = 0.0
    n_rpcs: int = 0
    gpu_overlap: float = 0.0   # fraction of stall hidden from the GPU
                               # (BGL-style pipelines cut GPU idle energy
                               # without cutting CPU/network work)


# ---- pure charge laws -----------------------------------------------------
# The meter and the trace ledger (repro_torch.obs) must agree bit-for-bit, and
# float addition is not associative — so both sides evaluate the SAME single
# expression per record call and accumulate the returned increments in the
# same emission order. Keep each increment one expression; regrouping it
# breaks reconciliation.

def step_charges(params: CostModelParams, s: StepSample) -> tuple[float, float]:
    """(gpu_j, cpu_j) increments for one :meth:`EnergyMeter.record_step`."""
    wall = s.t_compute + s.t_stall
    gpu = float(params.p_gpu_active) * s.t_compute + float(
        params.p_gpu_idle
    ) * s.t_stall * (1.0 - s.gpu_overlap)
    cpu = float(params.p_cpu_base) * wall + float(params.p_cpu_rpc) * s.t_cpu_comm
    return gpu, cpu


def background_charges(params: CostModelParams, cpu_s: float) -> tuple[float, float]:
    """(gpu_j, cpu_j) increments for one :meth:`EnergyMeter.record_background`."""
    return 0.0, float(params.p_cpu_rpc) * cpu_s


def sync_charges(
    params: CostModelParams, stall_s: float, cpu_comm_s: float = 0.0
) -> tuple[float, float]:
    """(gpu_j, cpu_j) increments for one :meth:`EnergyMeter.record_sync`."""
    gpu = float(params.p_gpu_idle) * stall_s
    cpu = float(params.p_cpu_base) * stall_s + float(params.p_cpu_rpc) * cpu_comm_s
    return gpu, cpu


@dataclasses.dataclass
class EnergyMeter:
    """Per-node energy integrator. All energies in Joules, times in s."""

    params: CostModelParams
    n_nodes: int = 4
    gpu_j: float = 0.0
    cpu_j: float = 0.0
    wall_s: float = 0.0
    comm_s: float = 0.0
    remote_bytes: float = 0.0
    n_rpcs: int = 0
    n_steps: int = 0
    epoch_marks: list = dataclasses.field(default_factory=list)

    def record_step(self, s: StepSample) -> None:
        wall = s.t_compute + s.t_stall
        gpu, cpu = step_charges(self.params, s)
        self.gpu_j += gpu
        self.cpu_j += cpu
        self.wall_s += wall
        self.comm_s += s.t_stall
        self.remote_bytes += s.remote_bytes
        self.n_rpcs += s.n_rpcs
        self.n_steps += 1

    def record_background(self, cpu_s: float, remote_bytes: float = 0.0,
                          n_rpcs: int = 0) -> None:
        """Background-thread communication work (double-buffered rebuilds):
        burns RPC-side CPU energy but no wall time (Section V-A)."""
        _, cpu = background_charges(self.params, cpu_s)
        self.cpu_j += cpu
        self.remote_bytes += remote_bytes
        self.n_rpcs += n_rpcs

    def record_sync(self, stall_s: float, cpu_comm_s: float = 0.0,
                    remote_bytes: float = 0.0, n_rpcs: int = 0) -> None:
        """Cluster gradient-sync cost: barrier wait + collective wire time.

        Unlike :meth:`record_step` this does NOT advance ``n_steps`` — the
        sync rides on an existing training step, so per-step observables
        (controller deltas, parity streams) are unperturbed. The GPU idles
        through the wait, the CPU does base work for the whole wait plus
        RPC protocol work for the collective itself.
        """
        gpu, cpu = sync_charges(self.params, stall_s, cpu_comm_s)
        self.gpu_j += gpu
        self.cpu_j += cpu
        self.wall_s += stall_s
        self.comm_s += stall_s
        self.remote_bytes += remote_bytes
        self.n_rpcs += n_rpcs

    def mark_epoch(self) -> None:
        self.epoch_marks.append(
            {
                "gpu_j": self.gpu_j,
                "cpu_j": self.cpu_j,
                "wall_s": self.wall_s,
            }
        )

    # ---- Table-I style totals (summed across nodes) -----------------------
    def totals_kj(self) -> dict:
        return {
            "gpu_kj": self.gpu_j * self.n_nodes / 1e3,
            "cpu_kj": self.cpu_j * self.n_nodes / 1e3,
            "total_kj": (self.gpu_j + self.cpu_j) * self.n_nodes / 1e3,
            "wall_s": self.wall_s,
        }

    def epoch_times(self) -> np.ndarray:
        walls = [0.0] + [m["wall_s"] for m in self.epoch_marks]
        return np.diff(np.asarray(walls))

    def cumulative_kj(self) -> np.ndarray:
        return np.asarray(
            [(m["gpu_j"] + m["cpu_j"]) * self.n_nodes / 1e3 for m in self.epoch_marks]
        )

    def mean_epoch_time(self) -> float:
        et = self.epoch_times()
        return float(et.mean()) if len(et) else 0.0
