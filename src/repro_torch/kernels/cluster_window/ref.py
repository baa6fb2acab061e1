"""The cluster env's window scan, plain: the eager masked loop.

The reference's ``substep`` loop (``repro/envs/cluster_sim.py:383-545``),
written out step by step with the port's tensor laws over a leading env
axis: the queue env's window (``kernels/queue_window/ref.py``) with the
cluster's terms added, ``MAX_WINDOW`` = 128 steps, each masked past the
env's ``eff_window``. The terms are the scripted peers' window, hit rate,
miss and rebuild arrivals (queued FIFO ahead of the ego's at the shared
owner NICs), the barrier wait on the slowest live peer, the ring
collective's wall and CPU time, and the drain (peer work, then the ego's
rebuild, then its misses). Each is an exact zero or one with no live peer
and clean factors, so this loop then gives the queue env's plain loop bit
for bit. The CPU runs this; on the card ``chip_smoke.py`` holds the CUDA
kernel against it.

Also the kernel's peer operand layout: the columns of the packed
tensors, in the order of the enums in ``kernels/csrc/fluid_window.cuh``
(the queue env's columns are ``kernels/queue_window/ref.py``'s).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.queue_window.ref import MAX_WINDOW, FabricState

# pscal (n, len(PEER_SCALARS)) float32: the peers' per-env constants, the
# hit-rate law's parameters and the peers' scalar state
PEER_SCALARS = (
    "n_live", "own_scale", "reactive", "coll_wall", "coll_cpu", "h_min",
    "h_max", "w_half", "gamma_h", "rebuild_c", "remote_nodes", "beta",
    "feature_bytes", "peer_left", "peer_window",
)
# pown (n, len(PEER_OWNERS), P) float32
PEER_OWNERS = ("link_scale", "demand_skew", "peer_on", "t_peer",
               "peer_slack", "peer_backlog")
# out: pstate (n, len(PEER_STATE)); the peer backlog out is (n, P)
PEER_STATE = ("peer_left", "peer_window")


@dataclasses.dataclass(frozen=True)
class Peers:
    """The scripted peers of one window, fixed across it: (n, P) per ego
    owner slot (slot i is peer rank i + 1's NIC) and (n,) per env.
    ``t_peer`` and ``peer_slack`` are each peer's compute-scaled
    ``t_base`` and prefetch slack; ``coll_wall`` and ``coll_cpu`` the ring
    collective's float32 twin at 1 + ``n_live`` ranks."""

    link_scale: torch.Tensor
    demand_skew: torch.Tensor
    peer_on: torch.Tensor
    t_peer: torch.Tensor
    peer_slack: torch.Tensor
    n_live: torch.Tensor
    own_scale: torch.Tensor
    reactive: torch.Tensor
    coll_wall: torch.Tensor
    coll_cpu: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PeerState:
    """The peers' carried state: the work they queued at the ego-visible
    NICs (n, P), the steps to their next rebuild and their current window
    (n,)."""

    peer_backlog: torch.Tensor
    peer_left: torch.Tensor
    peer_window: torch.Tensor


def _div(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` as a division (torch computes a number over a tensor as
    a product with the reciprocal)."""
    return torch.full_like(t, num) / t


def cluster_window_plain(cfg, params, sc, vol, fabric: FabricState,
                         peers: Peers, peer_state: PeerState,
                         uniforms: torch.Tensor, window: torch.Tensor,
                         eff_window: torch.Tensor, step_pos: torch.Tensor):
    """One window of every env: (the accumulators {t, e, e_ref, stall,
    rb_wait, n} (n,) and {per_row, active} (n, P), the new
    :class:`FabricState`, the new :class:`PeerState`). ``params`` carries
    the ego's compute-scaled ``t_base``; ``sc`` is the injected overlay's
    ``QueueScenario``; ``uniforms`` (n, MAX_WINDOW, 3, P) the queue env's
    window draws."""
    # the env's laws live in the core package, which imports this one
    from repro_torch.core import cost_model as cm
    from repro_torch.core import domain_rand as dr
    from repro_torch.core import queue_sim as qs

    n, n_owners = fabric.backlog.shape
    slope = params.gamma_c / params.beta
    t_base = params.t_base
    slack = cfg.slack_steps * t_base
    step_cost = qs.make_step_cost(params, slope, t_base, slack,
                                  sc.shared_factor)
    util_state, delta_level = fabric.util_state, fabric.delta_level
    backlog, rb_backlog = fabric.backlog, fabric.rb_backlog
    shared_backlog = fabric.shared_backlog
    peer_backlog = peer_state.peer_backlog
    peer_left, peer_window = peer_state.peer_left, peer_state.peer_window
    zeros = torch.zeros_like(backlog)
    acc = {k: torch.zeros_like(window) for k in
           ("t", "e", "e_ref", "stall", "rb_wait", "n")}
    acc["per_row"] = torch.zeros_like(backlog)
    acc["active"] = torch.zeros_like(backlog)
    active, miss_work = vol.active, vol.miss_work
    p_wait = params.p_gpu_idle + params.p_cpu_base
    ref_w = torch.full_like(window, qs.REFERENCE_WINDOW)

    # past every env's eff_window a step changes nothing (the kernel's
    # threads stop there): one read of the longest, and the loop ends
    for i in range(min(MAX_WINDOW, int(torch.ceil(eff_window.max())))
                   if eff_window.numel() else 0):
        live = (i < eff_window).float()
        on = live[:, None] > 0
        step = step_pos + i
        u = uniforms[:, i]

        new_util_state = dr.markov_onoff_update(u[:, 0], util_state,
                                                sc.p_on, sc.p_off)
        new_delta_level = dr.step_trace_update(u[:, 1], u[:, 2], delta_level,
                                               sc.p_switch, sc.level_max)
        util_state = torch.where(on, new_util_state, util_state)
        delta_level = torch.where(on, new_delta_level, delta_level)

        util = qs._utilization(sc, util_state, step, n_owners)
        d = qs._delta(cfg, sc, delta_level, step)
        phi_base = (1.0 - util) / (1.0 + slope[:, None] * d)
        phi = phi_base * peers.link_scale
        sigma_base = 1.0 / phi_base
        # the AR penalty from the injected sigma only: the deployed worker
        # reads fabric.sigma(), which has no link-rate term
        ar = params.kappa_ar * torch.clamp(sigma_base.amax(-1) - 1.0,
                                           min=0.0)

        # -- the scripted peers: their window, its miss and rebuild volumes
        sigma_seen = (1.0 / phi).amax(-1)
        boundary = (peer_left <= 0.0).float()
        w_target = torch.where(
            peers.reactive > 0.0,
            torch.clamp(_div(qs.REFERENCE_WINDOW, torch.sqrt(
                torch.clamp(sigma_seen, min=1.0))), 4.0, 32.0),
            ref_w)
        w_peer = torch.where(boundary > 0, w_target, peer_window)
        h_peer = cm.hit_rate_t(params, w_peer)
        peer_miss_rows = params.remote_nodes * (1.0 - h_peer) / n_owners
        peer_mw = params.beta * peer_miss_rows * params.feature_bytes
        peer_act = torch.clamp(peer_miss_rows * qs.ACTIVE_ROWS_SCALE, 0.0,
                               1.0)
        peer_rb = (qs.REBUILD_FETCH_FRAC * (params.remote_nodes / n_owners)
                   * w_peer ** params.rebuild_c * h_peer * params.beta
                   * params.feature_bytes)
        # arrivals at ego slot i: every live peer r != i sends its
        # per-owner share there; the rebuild bulk lands at their boundary
        others = torch.clamp(peers.n_live[:, None] - peers.peer_on, min=0.0)
        arrive = peers.demand_skew * others * (
            peer_act * peer_mw + boundary * peer_rb)[:, None]

        # -- the ego's cost: its misses queue behind the peers' work and
        #    its own backlogs (rebuild work FIFO ahead of earlier misses)
        t_step, stall, rb_leak, e_step, wall_o = step_cost(
            d, phi, ar, active, miss_work, backlog + rb_backlog + peer_backlog,
            rb_backlog + backlog + peer_backlog,
            torch.sign(rb_backlog.sum(-1)), shared_backlog, vol.rb_cpu,
            window)
        t_ref, _, _, e_ref, _ = step_cost(
            d, phi, ar, vol.active_ref, vol.miss_work_ref, zeros,
            vol.rb_work_ref, 1.0, 0.0, vol.rb_cpu_ref, qs.REFERENCE_WINDOW)

        # -- the barrier and the ring collective: a peer's miss fetch
        #    behind the same queues, and its fetch from the ego's own NIC
        q_tot = backlog + rb_backlog + peer_backlog
        peer_wall = (
            peer_act[:, None] * (params.alpha_rpc[:, None]
                                 + qs.PROP_RTT_S_PER_MS * d)
            + (q_tot + (peer_act * peer_mw)[:, None]) / phi).amax(-1)
        own_phi = torch.clamp(phi_base.mean(-1) * peers.own_scale, min=1e-6)
        wall_own = peer_act * (params.alpha_rpc
                               + qs.PROP_RTT_S_PER_MS * d.mean(-1)) \
            + peer_act * peer_mw / own_phi
        peer_raw = torch.maximum(peer_wall, wall_own)
        peer_stall = torch.clamp(peer_raw[:, None] - peers.peer_slack,
                                 min=0.0)
        peer_max = (peers.peer_on * (peers.t_peer + peer_stall)).amax(-1)
        wait = torch.clamp(peer_max - t_step, min=0.0)
        sync_s = wait + peers.coll_wall
        # EnergyMeter.record_sync: the GPU idles through the wait, the CPU
        # pays its base power for it and RPC work for the collective
        e_sync = p_wait * sync_s + params.p_cpu_rpc * peers.coll_cpu
        wait_ref = torch.clamp(peer_max - t_ref, min=0.0)
        e_sync_ref = p_wait * (wait_ref + peers.coll_wall) \
            + params.p_cpu_rpc * peers.coll_cpu
        t_wall = t_step + sync_s

        # -- the drain over t_wall: peer work first (queued ahead), then
        #    the ego's rebuild, then its misses; what does not drain stays
        cap = phi * t_wall[:, None]
        peer_served = torch.minimum(peer_backlog, cap)
        cap_ego = cap - peer_served
        rb_served = torch.minimum(rb_backlog, cap_ego)
        new_rb = rb_backlog - rb_served
        new_backlog = torch.clamp(
            backlog + active * miss_work - (cap_ego - rb_served), min=0.0)
        new_peer = peer_backlog - peer_served + arrive
        new_shared = torch.where(
            sc.shared_factor > 0.0,
            torch.clamp(shared_backlog + (active * miss_work).sum(-1)
                        - torch.clamp(sc.shared_factor, min=1e-6) * t_wall,
                        min=0.0),
            0.0)
        backlog = torch.where(on, new_backlog, backlog)
        rb_backlog = torch.where(on, new_rb, rb_backlog)
        shared_backlog = torch.where(live > 0, new_shared, shared_backlog)
        peer_backlog = torch.where(on, new_peer, peer_backlog)
        peer_left = torch.where(
            live > 0, torch.where(boundary > 0, w_peer - 1.0, peer_left - 1.0),
            peer_left)
        peer_window = torch.where(live > 0, w_peer, peer_window)

        per_row = wall_o / torch.clamp(vol.miss_rows, min=1e-6)
        rb_wait = torch.minimum((rb_backlog / phi).amax(-1), stall)

        acc["t"] = acc["t"] + live * t_wall
        acc["e"] = acc["e"] + live * (e_step + e_sync)
        acc["e_ref"] = acc["e_ref"] + live * (e_ref + e_sync_ref)
        acc["stall"] = acc["stall"] + live * (stall + sync_s)
        acc["rb_wait"] = acc["rb_wait"] + live * (rb_wait + rb_leak)
        acc["per_row"] = acc["per_row"] + live[:, None] * active * per_row
        acc["active"] = acc["active"] + live[:, None] * active
        acc["n"] = acc["n"] + live

    return (acc,
            FabricState(util_state, delta_level, backlog, rb_backlog,
                        shared_backlog),
            PeerState(peer_backlog, peer_left, peer_window))
