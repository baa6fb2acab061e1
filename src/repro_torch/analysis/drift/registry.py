"""greendrift twin registry: every paired implementation, declared once.

Port of ``repro/analysis/drift/registry.py``: the reference's 35 twins,
under the reference's names, pointed at the port's own sites. The port
carries the windowed cost law in its plain window loops
(``kernels/queue_window/ref.py``, ``kernels/cluster_window/ref.py``),
the event fabric and the worker's estimator; the batched tensor forms of
the congestion processes beside their numpy host forms; and the CUDA
window kernel, whose header (``kernels/csrc/fluid_window.cuh``) is out of
the AST's reach: ``chip_smoke.py`` holds each window kernel against its
plain loop on the card, bit for bit. Each pairing is declared here as a
:class:`Twin` so the static pass (``drift/__init__.check_project``) can
prove the sides still encode the same law, and the dynamic pass
(``scripts/check_determinism_torch.py twins``) can run them on matched
inputs. Three kinds:

``law``
    Sites name an anchor — a local variable whose (first) assignment RHS
    is the law fragment, or ``"return"`` for the function's return
    expression. Every site canonicalizes (``drift/canon.py``) and must
    match the FIRST site (the reference) structurally; the first
    divergent subtree is reported with both source spans. Where the port
    holds one more form of a law (a tensor form beside its numpy form),
    the form joins the twin as an extra site.

``shared-helper``
    The law exists once; the twin obligation is that the caller site
    still CALLS the shared helper (terminal callee name). Deleting the
    call and re-inlining a private copy is the drift mode this catches.
    A caller site that reaches the helper through one named intermediary
    says so in ``via`` (the port's cluster env builds a window's operands
    in ``queue_sim.window_operands``): it must call the intermediary,
    and the intermediary, resolved by module and qualname, must call the
    helper.

``dynamic``
    Sides are intentionally different shapes (event-driven vs closed
    form, byte accounting vs fluid fraction) so structural comparison
    cannot apply. Statically we pin only that both qualnames still
    resolve; the numeric agreement lives in ``check_determinism_torch.py
    twins``, which refuses to pass if a ``dynamic`` twin has no runner.

Suppression: a divergence is silenced line-scoped by
``# greenlint: twin-ok <why>`` on (or above) EITHER side's anchor line.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Site:
    """One side of a twin: where an implementation (fragment) lives."""

    module: str               # repro_torch-relative posix path
    qualname: str             # dotted; classes and nested defs supported
    anchor: str | None = None  # local var whose assignment RHS is the law,
    #                            or "return"; None for non-law sites
    inline: tuple[str, ...] = ()  # single-assignment locals substituted
    #                               into the anchor before canonicalizing
    via: Site | None = None   # shared-helper caller: the one function
    #                           through which it calls the helper


@dataclasses.dataclass(frozen=True)
class Twin:
    """One registered pairing of implementations."""

    name: str
    kind: str                       # "law" | "shared-helper" | "dynamic"
    sites: tuple[Site, ...]         # law/dynamic: first site is reference
    helper: Site | None = None      # shared-helper: the helper definition
    note: str = ""


_QS = "core/queue_sim.py"
_CS = "envs/cluster_sim.py"
_DR = "core/domain_rand.py"
_CM = "core/cost_model.py"
_QW = "kernels/queue_window/ref.py"
_CW = "kernels/cluster_window/ref.py"
_COLL = "distributed/collectives.py"
# the cluster env's window reaches the volume and spill helpers here
_CS_WINDOW = Site(_CS, "_window_dynamics",
                  via=Site(_QS, "window_operands"))


def _collective(anchor: str) -> tuple[Site, ...]:
    return (Site(_COLL, "ring_collective_cost", anchor),
            Site(_CS, "ring_collective_t", anchor))


def _delta(anchor: str, tensor_inline=(), np_inline=()) -> tuple[Site, ...]:
    return (Site(_DR, "delta_at", anchor, inline=tensor_inline),
            Site(_DR, "delta_at_np", anchor, inline=np_inline))


def _paper(anchor: str, np_inline=()) -> tuple[Site, ...]:
    return (Site(_DR, "paper_schedule_delta", anchor),
            Site(_DR, "paper_schedule_delta_np", anchor, inline=np_inline),
            Site(_DR, "paper_schedule_delta_t", anchor))


TWINS: tuple[Twin, ...] = (
    # ---- the fluid service law: one formula, three implementations ----
    Twin(
        name="service-law",
        kind="law",
        sites=(
            Site(_QW, "queue_window_plain", "phi"),
            Site(_CW, "cluster_window_plain", "phi_base"),
            Site("net/fabric.py", "Fabric._transfer_locked", "service"),
        ),
        note="phi = (1 - u) / (1 + slope * delta): the congestion service "
             "factor every cost path divides by. The envs' windows run it "
             "in their plain loops on the CPU; the CUDA kernels' header "
             "kernels/csrc/fluid_window.cuh is out of the AST's reach and "
             "is held by chip_smoke.py's kernel-against-plain checks",
    ),
    # ---- cluster twin's scripted-peer law vs the shared ego law ----
    Twin(
        name="peer-miss-rows",
        kind="law",
        sites=(
            Site(_QS, "action_volumes", "miss_rows"),
            Site(_CW, "cluster_window_plain", "peer_miss_rows"),
        ),
    ),
    Twin(
        name="peer-miss-work",
        kind="law",
        sites=(
            Site(_QS, "action_volumes", "miss_work"),
            Site(_CW, "cluster_window_plain", "peer_mw"),
        ),
    ),
    Twin(
        name="peer-active",
        kind="law",
        sites=(
            Site(_QS, "action_volumes", "active"),
            Site(_CW, "cluster_window_plain", "peer_act"),
        ),
    ),
    # ---- ring collective: host law vs the cluster env's tensor form ----
    # (the `chunk` anchors intentionally differ: the tensor side guards
    # the n==0 division that the host side excludes by precondition)
    Twin(name="collective-phases", kind="law",
         sites=_collective("phases")),
    Twin(name="collective-per-phase", kind="law",
         sites=_collective("per_phase")),
    Twin(name="collective-wall", kind="law", sites=_collective("wall")),
    Twin(name="collective-cpu", kind="law", sites=_collective("cpu")),
    # ---- domain_rand tensor<->np twins (training envs vs fabric) ----
    Twin(name="delta-active", kind="law", sites=_delta("active")),
    Twin(name="delta-onehot", kind="law", sites=_delta("onehot_a")),
    Twin(name="delta-flip", kind="law",
         sites=_delta("flip", tensor_inline=("period",), np_inline=("p",))),
    Twin(name="delta-switching", kind="law", sites=_delta("switching")),
    Twin(name="delta-osc", kind="law",
         sites=_delta("osc", tensor_inline=("period",), np_inline=("p",))),
    Twin(
        name="delta-branches",
        kind="law",
        sites=_delta("branches"),
        note="the archetype table itself; `sev` is excluded (mask-multiply "
             "vs scalar branch) and covered numerically by the twins target",
    ),
    # ---- the paper schedule: float32 host form (the reference's jnp
    # values), float64 fabric form, and the envs' tensor form ----
    Twin(name="paper-schedule-phase", kind="law", sites=_paper("phase")),
    Twin(name="paper-schedule-window", kind="law",
         sites=_paper("in_window")),
    Twin(name="paper-schedule-severity", kind="law", sites=_paper("sev")),
    Twin(name="paper-schedule-links", kind="law",
         sites=_paper("onehot_b", np_inline=("link_b", "two_links"))),
    Twin(
        name="diurnal-law",
        kind="law",
        sites=(
            Site(_DR, "diurnal_util", "return"),
            Site("net/background.py", "DiurnalLoad.utilization", "return"),
        ),
        note="the tensor twin guards period with clamp(p, min=1) upstream "
             "of the anchor; the shared return shape is the law",
    ),
    # ---- shared-helper obligations: the cluster env must keep calling
    # the queue_sim single-source-of-truth helpers (the volumes and the
    # spill through queue_sim.window_operands), and both plain window
    # loops price a step through make_step_cost ----
    Twin(
        name="cluster-action-volumes",
        kind="shared-helper",
        helper=Site(_QS, "action_volumes"),
        sites=(_CS_WINDOW,),
    ),
    Twin(
        name="cluster-reference-volumes",
        kind="shared-helper",
        helper=Site(_QS, "reference_volumes"),
        sites=(_CS_WINDOW,),
    ),
    Twin(
        name="cluster-step-cost",
        kind="shared-helper",
        helper=Site(_QS, "make_step_cost"),
        sites=(Site(_CW, "cluster_window_plain"),
               Site(_QW, "queue_window_plain")),
    ),
    Twin(
        name="cluster-summary",
        kind="shared-helper",
        helper=Site(_QS, "summarize_window"),
        sites=(Site(_CS, "_window_dynamics"),),
    ),
    Twin(
        name="cluster-mem-spill",
        kind="shared-helper",
        helper=Site(_QS, "mem_spill"),
        sites=(_CS_WINDOW,),
    ),
    Twin(
        name="worker-rpc-wall",
        kind="shared-helper",
        helper=Site(_CM, "rpc_wall_s"),
        sites=(Site("train/worker.py", "TrainerWorker.step"),),
        note="the worker's per-owner estimator feeding the controller "
             "deque must stay the shared Eq. 4 closed form",
    ),
    Twin(
        name="trainer-rpc-cpu",
        kind="shared-helper",
        helper=Site(_CM, "rpc_cpu_s"),
        sites=(Site("train/gnn_trainer.py", "_fetch_time"),),
    ),
    Twin(
        name="compute-step-law",
        kind="shared-helper",
        helper=Site(_CM, "compute_step_s"),
        sites=(Site("core/calibration.py", "calibrate_compute"),),
        note="the t_base calibration must predict through the shared "
             "per-step compute law",
    ),
    # ---- dynamic-only twins: different shapes, numeric agreement pinned
    # by `scripts/check_determinism_torch.py twins` ----
    Twin(
        name="fabric-rpc-wall",
        kind="dynamic",
        sites=(
            Site(_CM, "rpc_wall_s"),
            Site("net/fabric.py", "probe_rpc"),
        ),
        note="one isolated clean-fabric transfer must equal the closed "
             "form: alpha + prop*delta + beta*p + gamma_c*p*delta",
    ),
    Twin(
        name="store-headroom",
        kind="dynamic",
        sites=(
            Site(_QS, "mem_headroom"),
            Site("store/tiered.py", "TieredFeatureStore.headroom"),
        ),
        note="fluid headroom of a W working set == the tiered store's "
             "byte accounting at block-aligned residency",
    ),
    Twin(
        name="store-spill",
        kind="dynamic",
        sites=(
            Site(_QS, "mem_spill"),
            Site("store/host_tier.py", "HostTier.touch"),
        ),
        note="no-overflow endpoint: spill multiplier 1.0 iff a matching "
             "byte budget produces zero block fetches",
    ),
    Twin(
        name="delta-np-numeric",
        kind="dynamic",
        sites=(
            Site(_DR, "delta_at"),
            Site(_DR, "delta_at_np"),
        ),
        note="full-profile numeric agreement incl. `sev`, which the law "
             "twins exclude",
    ),
    Twin(
        name="paper-schedule-numeric",
        kind="dynamic",
        sites=(
            Site(_DR, "paper_schedule_delta"),
            Site(_DR, "paper_schedule_delta_np"),
            Site(_DR, "paper_schedule_delta_t"),
        ),
    ),
    Twin(
        name="collective-numeric",
        kind="dynamic",
        sites=(
            Site(_COLL, "ring_collective_cost"),
            Site(_CS, "ring_collective_t"),
        ),
    ),
    Twin(
        name="sigma-law",
        kind="dynamic",
        sites=(
            Site(_CM, "sigma_from_delta"),
            Site("net/fabric.py", "Fabric.sigma"),
        ),
        note="fabric-reported sigma at (u=0, delta) must equal "
             "1 + (gamma_c/beta) * delta",
    ),
    Twin(
        name="compute-law-numeric",
        kind="dynamic",
        sites=(
            Site(_CM, "compute_step_s"),
            Site("train/compute.py", "ComputeEngine.step"),
        ),
        note="measured lane -> calibrate_compute -> t_base: engine step "
             "times under a virtual clock must round-trip the shared law "
             "exactly (timing plumb-through, and OLS law recovery)",
    ),
)


def dynamic_twins() -> tuple[Twin, ...]:
    """The twins whose agreement is pinned numerically, not structurally
    (``scripts/check_determinism_torch.py twins`` iterates this)."""
    return tuple(t for t in TWINS if t.kind == "dynamic")
