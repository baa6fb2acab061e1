"""Mixture-of-Experts FFN with sort-based capacity dispatch.

Port of ``repro/models/lm/moe.py``: token-choice top-k routing
(DeepSeek/Moonlight style: softmax -> top-k -> renormalize), then a
gather-based dispatch without the O(T x E x C) one-hot tensor of the
GShard formulation:

  1. flatten the (token, k) assignments, sort them by expert id,
  2. position in its expert = rank within the expert's run,
  3. scatter token ids into a dispatch table (E, C); assignments past the
     capacity C are dropped (their combine weight is simply missing),
  4. gather -> per-expert batched products -> weighted gather back.

Shared experts (DeepSeekMoE) run densely on every token. Every shape is
static and nothing is read back to the host; the reference computes these
in plain JAX, outside any Pallas kernel, and so does the port (gathers,
``torch.bmm``, scatters). What differs:

- ``jax.lax.top_k`` puts the lower index first among equal values and
  ``torch.topk`` does not; :func:`route_topk` takes the first ``k`` of a
  stable descending sort, which keeps the lower index first;
- ``shard_activation`` is the identity on one card; over a mesh (x a
  DTensor) :func:`moe_ffn` runs :func:`_moe_ffn_sharded`, whose expert
  products sit between the reference's two sites;
- the per-expert counts are a ``scatter_add_`` of ones (``bincount``
  would read its length back from the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.sharding import shard_activation
from repro_torch.models.lm.layers import swiglu

ECD = ("experts", "expert_capacity", "embed")   # the dispatch tensors' axes


def route_topk(gates_logits: torch.Tensor, top_k: int):
    """softmax -> top-k -> renormalize, in float32. Returns (weights
    (T, k), experts (T, k)); among equal probabilities the lower expert
    index comes first, as ``jax.lax.top_k`` orders them."""
    probs = torch.softmax(gates_logits.float(), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :top_k], topi[:, :top_k]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    return topv, topi


def capacity_of(t: int, n_experts: int, top_k: int,
                capacity_factor: float, no_drop: bool) -> int:
    """Slots an expert has for ``t`` tokens: ``t`` under ``no_drop`` (a
    token meets an expert at most once, so nothing drops), else the
    reference's ``min(max(int(top_k * t * capacity_factor / e), 1), t)``
    in Python floats."""
    if no_drop:
        return t
    return min(max(int(top_k * t * capacity_factor / n_experts), 1), t)


def build_dispatch(experts: torch.Tensor, n_experts: int, capacity: int):
    """experts: (T, k) expert ids. Returns (dispatch (E, C) int32 token ids,
    T for an empty slot; combine_slot (T, k) int32 flat slot id, -1 where
    the assignment was dropped). Earlier tokens win an expert's capacity
    (GShard priority)."""
    t, k = experts.shape
    dev = experts.device
    n = t * k
    flat_e = experts.reshape(-1).long()
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    # unique keys: the sort by expert keeps the assignments' order within
    # an expert, whatever the sort's stability
    order = torch.argsort(flat_e * n + torch.arange(n, device=dev))
    se, st = flat_e[order], flat_t[order]
    counts = torch.zeros(n_experts, dtype=torch.long, device=dev)
    counts.scatter_add_(0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n, device=dev) - starts[se]
    keep = pos_in_e < capacity
    slot = se * capacity + pos_in_e                   # flat (E*C) slot
    overflow = n_experts * capacity                   # the scratch slot
    slot = torch.where(keep, slot, overflow)
    dispatch_flat = torch.full((overflow + 1,), t, dtype=torch.int32,
                               device=dev)
    # only the scratch slot is written more than once, and it is dropped
    dispatch_flat[slot] = st.int()
    dispatch = dispatch_flat[:-1].reshape(n_experts, capacity)
    inv = torch.zeros(n, dtype=torch.int32, device=dev)
    inv[order] = torch.where(keep, slot, -1).int()
    return dispatch, inv.reshape(t, k)


def moe_ffn(x: torch.Tensor,            # (T, D) flattened tokens
            router_w: torch.Tensor,     # (D, E)
            w_gate: torch.Tensor,       # (E, D, F)
            w_up: torch.Tensor,         # (E, D, F)
            w_down: torch.Tensor,       # (E, F, D)
            top_k: int,
            capacity_factor: float = 1.25,
            no_drop: bool = False) -> torch.Tensor:
    """The routed experts' output (T, D) in x's dtype. The router's logits
    are ``x @ router_w`` in x's dtype (bf16 for the bf16 models, as the
    reference rounds them) before the float32 softmax."""
    t, d = x.shape
    e = router_w.shape[1]
    capacity = capacity_of(t, e, top_k, capacity_factor, no_drop)
    if shlib.is_dtensor(x):
        return _moe_ffn_sharded(x, router_w, w_gate, w_up, w_down, top_k,
                                capacity)
    weights, experts = route_topk(x @ router_w, top_k)
    dispatch, combine_slot = build_dispatch(experts, e, capacity)

    x_pad = torch.cat([x, x.new_zeros((1, d))])
    xe = x_pad[dispatch.long()]                       # (E, C, D)
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down)                         # (E, C, D)

    # combine: each (token, k) reads its slot's output, weighted, summed
    ye_flat = torch.cat([ye.reshape(e * capacity, d), ye.new_zeros((1, d))])
    live = combine_slot >= 0
    slot = torch.where(live, combine_slot, e * capacity).long()
    per_k = ye_flat[slot]                             # (T, k, D)
    w = torch.where(live, weights, 0.0).to(per_k.dtype)
    return torch.einsum("tkd,tk->td", per_k, w)


def _moe_ffn_sharded(x, router_w, w_gate, w_up, w_down, top_k: int,
                     capacity: int):
    """:func:`moe_ffn` over a mesh, with the reference's global routing:
    the capacity is the whole (global) token count's, and earlier tokens
    win an expert's slots across all devices.

    * Every device routes all T tokens: the router's logits (T, E) are
      gathered (T x E values, no (E, C, D) tensor), and the sort, the
      per-expert counts and the (E, C) dispatch table run on each device
      (``local_map``; the sort and the scatters have no DTensor
      strategy). From a gathered value only sort positions index
      anything, so every index stays in range whatever the values.
    * A device gathers the tokens of its own (experts, capacity) block of
      the dispatch tensors, ``("experts", "expert_capacity", "embed")``
      at the rules' placements, from the gathered (T, D) tokens: the
      dispatch tensors (E, C, D) are only ever held a block a device.
    * The expert products run on the local block with the local experts'
      weights (their FSDP rows gathered).
    * Each device adds its block's weighted outputs into a (T, D)
      partial sum of its tokens' outputs; the partial sums are reduced
      onto x's placements (a reduce-scatter over the batch's mesh dims
      and an all-reduce over the others).

    The combine sums a token's k expert outputs in another order than
    the one-device einsum: equal up to float reassociation."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dmesh = x.device_mesh
    rules = shlib.current_rules()
    n = dmesh.ndim
    t, d = x.shape
    e = router_w.shape[1]
    ecd_pl = shlib.placements_for(shlib.spec_for(ECD, rules, dmesh), dmesh)
    ec_pl = tuple(p if isinstance(p, Shard) and p.dim < 2 else Replicate()
                  for p in ecd_pl)
    (e_n, c_n, _), (e0, c0, _) = shlib.local_slices((e, capacity, d),
                                                    ecd_pl, dmesh)
    # the experts' weights: experts as the dispatch tensors, nothing else
    w_pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0
                 else Replicate() for p in ecd_pl)
    w_grad = tuple(p if isinstance(p, Shard) else Partial() for p in w_pl)
    rep, part = (Replicate(),) * n, (Partial(),) * n

    def dispatch(x_all, logits):
        weights, experts = route_topk(logits, top_k)
        table, combine_slot = build_dispatch(experts, e, capacity)
        block = table[e0:e0 + e_n, c0:c0 + c_n]
        # each slot's combine weight (0 where empty), and its token's row
        live = combine_slot >= 0
        slot = torch.where(live, combine_slot, e * capacity).reshape(-1)
        w_slot = torch.zeros(e * capacity + 1, dtype=weights.dtype,
                             device=weights.device).scatter(
            0, slot.long(), torch.where(live, weights, 0.0).reshape(-1))
        w_slot = w_slot[:-1].reshape(e, capacity)[e0:e0 + e_n, c0:c0 + c_n]
        x_pad = torch.cat([x_all, x_all.new_zeros((1, d))])
        return x_pad[block.long()], w_slot, block

    xe, w_slot, block = local_map(
        dispatch, out_placements=(ecd_pl, ec_pl, ec_pl),
        in_placements=(rep, rep), in_grad_placements=(part, part),
        device_mesh=dmesh, redistribute_inputs=True)(
        shlib.replicated(x), shlib.replicated(x @ router_w))
    xe = shard_activation(xe, ECD)

    def experts_ffn(xe, wg, wu, wd):
        h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
        return torch.bmm(h, wd)

    ye = local_map(experts_ffn, out_placements=list(ecd_pl),
                   in_placements=(ecd_pl, w_pl, w_pl, w_pl),
                   in_grad_placements=(ecd_pl, w_grad, w_grad, w_grad),
                   device_mesh=dmesh, redistribute_inputs=True)(
        xe, w_gate, w_up, w_down)
    ye = shard_activation(ye, ECD)

    def combine(ye, w_slot, block):
        out = ye.new_zeros((t + 1, d))
        contrib = ye * w_slot[..., None].to(ye.dtype)
        out.index_add_(0, block.reshape(-1).long(), contrib.reshape(-1, d))
        return out[:t]

    y = local_map(combine, out_placements=list(part),
                  in_placements=(ecd_pl, ec_pl, ec_pl),
                  device_mesh=dmesh, redistribute_inputs=True)(
        ye, w_slot, block)
    return y.redistribute(dmesh, x.placements)


def shared_expert_ffn(x, w_gate, w_up, w_down):
    """DeepSeekMoE shared experts: dense SwiGLU over every token."""
    return swiglu(x, w_gate, w_up, w_down)
