"""Topology-polymorphic aggregation: ``compile_plan`` + one ``execute``
(port of :mod:`repro.agg.plan`).

Every topology — the paper's linear chain, a permuted chain order, or a
routed :class:`~repro_torch.topo.tree.AggTree` — lowers to one canonical
form, the :class:`AggPlan`: a padded ``(L, W)`` level schedule (L levels run
in order, the W slots of a level run as the lanes of one level step).
``execute(cfg, plan, ...)`` is the single round entry point, bit-exact to
:func:`repro_torch.core.chain.run_chain` on chain plans;
``execute_batched`` runs B cohorts' rounds with one level step per level
for all of them.

The plan's arrays stay numpy on the host; ``execute`` runs on the device of
the gradients it is given.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.algorithms import (AggConfig, AggKind, HopStats,
                                         level_step, level_step_batched)
from repro_torch.topo.tree import PS, AggTree, build_schedule, path_tree

Tensor = torch.Tensor

Topology = Union[int, AggTree, Sequence, np.ndarray]


@dataclasses.dataclass(frozen=True)
class AggPlan:
    """Canonical padded level schedule — the compiled form of a topology.

    ``node_id[l, w]`` is the client run in slot w of level l, deepest level
    first (padding slots hold K, a zero dummy row); ``slot_mask`` is 1.0 for
    real slots; ``parent_row[l, w]`` is the inbox row receiving that slot's
    γ (client index, K..K+R−1 for the R sink rows, K+R trash row for
    padding; single-sink plans have R = 1 and their sink K is the PS);
    ``flat_pos[k]`` maps client k back out of schedule order. ``alive[k]``
    is 0.0 for stranded stubs, folded into ``participate`` by
    :func:`execute`. ``q_budget`` (optional int32 [K]) carries per-client
    local Top-Q budgets.
    """

    node_id: np.ndarray       # [L, W] int32
    slot_mask: np.ndarray     # [L, W] float32
    parent_row: np.ndarray    # [L, W] int32
    flat_pos: np.ndarray      # [K] int32
    alive: np.ndarray         # [K] float32
    q_budget: Optional[np.ndarray] = None   # [K] int32
    num_clients: int = 0
    num_sinks: int = 1

    @property
    def shape(self) -> tuple:
        """The padded ``(L, W)``."""
        return tuple(self.node_id.shape)

    def pad(self, shape: tuple) -> "AggPlan":
        """Re-pad to a larger ``(L, W)`` (bit-exact: padding slots run the
        zero dummy row and scatter into the trash row)."""
        big_l, big_w = shape
        l, w = self.shape
        if (big_l, big_w) == (l, w):
            return self
        if big_l < l or big_w < w:
            raise ValueError(f"cannot shrink plan {self.shape} to {shape}")
        k = self.num_clients
        node_id = np.full((big_l, big_w), k, np.int32)
        slot_mask = np.zeros((big_l, big_w), np.float32)
        parent_row = np.full((big_l, big_w), k + self.num_sinks, np.int32)
        node_id[:l, :w] = self.node_id
        slot_mask[:l, :w] = self.slot_mask
        parent_row[:l, :w] = self.parent_row
        li, wi = np.divmod(np.asarray(self.flat_pos, np.int64), w)
        flat_pos = (li * big_w + wi).astype(np.int32)
        return AggPlan(node_id=node_id, slot_mask=slot_mask,
                       parent_row=parent_row, flat_pos=flat_pos,
                       alive=self.alive, q_budget=self.q_budget,
                       num_clients=k, num_sinks=self.num_sinks)


# ---------------------------------------------------------------------------
# compile_plan
# ---------------------------------------------------------------------------

def _order_to_tree(order: np.ndarray, num_clients: Optional[int]) -> AggTree:
    """A (possibly permuted) chain order → the equivalent path tree.

    ``order[0]`` is the client adjacent to the PS, ``order[-1]`` the far
    end. Must be a full permutation — exclude nodes via ``participate``.
    """
    order = np.asarray(order, np.int64).reshape(-1)
    k = num_clients if num_clients is not None else len(order)
    if sorted(order.tolist()) != list(range(k)):
        raise ValueError(
            f"chain order must be a permutation of 0..{k - 1}; got "
            f"{order.tolist()} (exclude nodes via participate, not order)")
    parent = np.empty((k,), np.int64)
    parent[order[0]] = PS
    parent[order[1:]] = order[:-1]
    return AggTree(parent=tuple(int(p) for p in parent))


def as_tree(topology: Topology, num_clients: Optional[int] = None) -> AggTree:
    """Coerce a topology description to an :class:`AggTree`:

    * ``int K`` — the paper's identity chain over K clients;
    * :class:`AggTree` — used as-is;
    * anything with a ``.tree()`` method (``repro_torch.fed.topology``'s
      ``TreeTopology``) — its routed tree;
    * a ``ConstellationGraph`` — routed by the shortest-path policy;
    * anything with an ``.order()`` method (``ChainTopology``) — its chain;
    * 1-D int sequence — a (healed/permuted) chain visiting order.
    """
    if isinstance(topology, AggTree):
        return topology
    if isinstance(topology, (int, np.integer)):
        return path_tree(int(topology))
    if hasattr(topology, "tree") and callable(topology.tree):
        return topology.tree()
    if hasattr(topology, "client_nodes"):         # ConstellationGraph
        from repro_torch.topo.routing import shortest_path_tree
        return shortest_path_tree(topology)
    if hasattr(topology, "order") and callable(topology.order):
        return _order_to_tree(np.asarray(topology.order()), num_clients)
    return _order_to_tree(np.asarray(topology), num_clients)


def compile_plan(topology: Topology, *,
                 num_clients: Optional[int] = None,
                 pad_to: Optional[tuple] = None,
                 q_budget: Optional[np.ndarray] = None) -> AggPlan:
    """Lower a topology to its canonical :class:`AggPlan`.

    ``pad_to=(L, W)`` pads the level schedule; ``q_budget`` attaches
    per-client local Top-Q budgets.
    """
    tree = as_tree(topology, num_clients)
    k = tree.num_clients
    sched = build_schedule(tree)
    alive = (np.ones((k,), np.float32) if tree.reachable is None
             else np.asarray(tree.reachable, np.float32))
    qb = None
    if q_budget is not None:
        qb = np.asarray(q_budget, np.int32).reshape(-1)
        if qb.shape != (k,):
            raise ValueError(f"q_budget must be [K={k}]; got {qb.shape}")
    plan = AggPlan(node_id=np.asarray(sched.node_id, np.int32),
                   slot_mask=np.asarray(sched.slot_mask, np.float32),
                   parent_row=np.asarray(sched.parent_row, np.int32),
                   flat_pos=np.asarray(sched.flat_pos, np.int32),
                   alive=alive, q_budget=qb, num_clients=k)
    if pad_to is not None:
        plan = plan.pad(tuple(pad_to))
    return plan


# ---------------------------------------------------------------------------
# Bandwidth-aware budgets
# ---------------------------------------------------------------------------

def bandwidth_budgets(cfg: AggConfig, tree: AggTree, *,
                      floor: int = 1) -> np.ndarray:
    """Per-client local Top-Q budgets scaled by uplink bandwidth.

    ``q_k = max(floor, round(q_base · bw_k / max bw))`` in float64, where
    ``q_base`` is the algorithm's local budget (``q``, or ``q_local`` for
    the TC variants). Narrow uplinks transmit fewer nonzeros; zero-bandwidth
    stubs get the floor (they never transmit anyway).
    """
    if tree.uplink_bw_bps is None:
        raise ValueError("tree has no per-link bandwidth (built by hand?) — "
                         "route it from a ConstellationGraph")
    bw = np.asarray(tree.uplink_bw_bps, np.float64)
    base = (cfg.q_local if cfg.kind in (AggKind.TC_SIA, AggKind.CL_TC_SIA)
            else cfg.q)
    pos = bw[bw > 0]
    if pos.size == 0:
        return np.full((tree.num_clients,), floor, np.int32)
    scaled = np.round(base * bw / pos.max())
    return np.where(bw > 0, np.maximum(floor, scaled),
                    floor).astype(np.int32)


# ---------------------------------------------------------------------------
# execute — the single round entry point
# ---------------------------------------------------------------------------

class RoundResult(NamedTuple):
    aggregate: Tensor     # what the PS receives (Σ over its children), [d];
                          # forest plans (R > 1 sinks) get [R, d]
    e_new: Tensor         # updated EF memory, [K, d] (client index order)
    stats: HopStats       # per-hop stats, leaves [K] (client index order)


def execute(
    cfg: AggConfig,
    plan: AggPlan,
    grads: Tensor,                 # [K, d] per-client effective gradients g_k
    e: Tensor,                     # [K, d] EF memory
    weights: Tensor,               # [K]    D_k
    *,
    global_mask: Optional[Tensor] = None,  # [d] TCS mask m^t (TC algorithms)
    participate: Optional[Tensor] = None,  # [K] 0/1 straggler mask
) -> RoundResult:
    """One aggregation round over a compiled plan (any topology).

    The L levels run deepest first; :func:`repro_torch.core.algorithms.
    level_step` runs every node of a level as one lane. Children's partial
    aggregates merge at each parent in slot order — one add per real slot,
    the order of the reference's scatter-add — so a parent's sum is the
    same on every device (a CUDA ``index_add_`` would add in no fixed
    order). Padding slots run the zero dummy row and are never added.
    Runs on the device of ``grads``.
    """
    k, d = grads.shape
    dev, dt = grads.device, grads.dtype
    if plan.num_clients != k:
        raise ValueError(f"plan has {plan.num_clients} clients, grads {k}")
    if global_mask is None:
        global_mask = torch.zeros((d,), dtype=dt, device=dev)
    if participate is None:
        participate = torch.ones((k,), dtype=dt, device=dev)
    participate = participate * torch.as_tensor(plan.alive, dtype=dt,
                                                device=dev)
    lvl = level_step(cfg)

    # one zero dummy row (index K) backs the padding slots
    zrow = torch.zeros((1, d), dtype=dt, device=dev)
    g_ext = torch.cat([grads, zrow])
    e_ext = torch.cat([e, zrow])
    w_ext = torch.cat([weights, weights.new_zeros((1,))])
    p_ext = torch.cat([participate, participate.new_zeros((1,))])
    q_ext = None
    if plan.q_budget is not None:
        q_ext = torch.cat([torch.as_tensor(plan.q_budget, dtype=torch.int32,
                                           device=dev),
                           torch.zeros((1,), dtype=torch.int32, device=dev)])

    # inbox rows: 0..K−1 per-client incoming sums, K..K+R−1 the sink rows
    # (R = 1: the PS), K+R = trash
    r_sinks = plan.num_sinks
    inbox = torch.zeros((k + r_sinks + 1, d), dtype=dt, device=dev)
    node_id = torch.as_tensor(np.asarray(plan.node_id, np.int64), device=dev)
    slot_mask = torch.as_tensor(plan.slot_mask, dtype=torch.float32,
                                device=dev)
    real = np.asarray(plan.slot_mask) > 0
    parent = np.asarray(plan.parent_row)
    e_lvl, st_lvl = [], []
    for li in range(node_id.shape[0]):
        ids = node_id[li]
        gamma_out, e_new, stats = lvl(
            g_ext[ids], inbox[ids], e_ext[ids], w_ext[ids], p_ext[ids],
            global_mask, None if q_ext is None else q_ext[ids],
            slot_mask[li])
        for wi in np.flatnonzero(real[li]):
            inbox[int(parent[li, wi])] += gamma_out[wi]
        e_lvl.append(e_new)
        st_lvl.append(stats)

    # level outputs are [L, W, ...] in schedule order → client index order
    pos = torch.as_tensor(np.asarray(plan.flat_pos, np.int64), device=dev)
    e_out = torch.stack(e_lvl).reshape(-1, d)[pos]
    stats = HopStats(*(torch.stack(leaf).reshape(-1)[pos]
                       for leaf in zip(*st_lvl)))
    agg = inbox[k] if r_sinks == 1 else inbox[k:k + r_sinks]
    return RoundResult(aggregate=agg, e_new=e_out, stats=stats)


# ---------------------------------------------------------------------------
# execute_batched — B cohorts per level step (multi-tenant rounds)
# ---------------------------------------------------------------------------

def stack_plans(plans: Sequence[AggPlan]) -> AggPlan:
    """Stack B shape-identical plans into one cohort-batched plan whose
    array leaves carry a leading cohort axis ``[B, ...]``.

    The plans must agree on ``(L, W)``, client count, sink count and
    ``q_budget`` presence: pad them to a common shape first
    (:func:`repro_torch.agg.schedule.common_shape`, or let
    :class:`repro_torch.agg.batching.RoundScheduler` do it). A stacked plan
    is taken only by :func:`execute_batched`.
    """
    if not plans:
        raise ValueError("stack_plans needs at least one plan")
    p0 = plans[0]
    for p in plans[1:]:
        if p.shape != p0.shape:
            raise ValueError(f"plan shapes differ: {p.shape} vs {p0.shape} "
                             f"(pad to a common shape first)")
        if (p.num_clients, p.num_sinks) != (p0.num_clients, p0.num_sinks):
            raise ValueError("stacked plans must share client/sink counts")
        if (p.q_budget is None) != (p0.q_budget is None):
            raise ValueError("stacked plans must agree on q_budget presence")
    stk = lambda leaf: np.stack([np.asarray(getattr(p, leaf))  # noqa: E731
                                 for p in plans])
    return AggPlan(node_id=stk("node_id"), slot_mask=stk("slot_mask"),
                   parent_row=stk("parent_row"), flat_pos=stk("flat_pos"),
                   alive=stk("alive"),
                   q_budget=None if p0.q_budget is None else stk("q_budget"),
                   num_clients=p0.num_clients, num_sinks=p0.num_sinks)


def execute_batched(
    cfg: AggConfig,
    plan: AggPlan,
    grads: Tensor,                 # [B, K, d] per-cohort client gradients
    e: Tensor,                     # [B, K, d] per-cohort EF memory
    weights: Tensor,               # [B, K]
    *,
    global_mask: Optional[Tensor] = None,  # [B, d] per-cohort TCS masks
    participate: Optional[Tensor] = None,  # [B, K] per-cohort stragglers
) -> RoundResult:
    """B independent aggregation rounds, one level step per level for all.

    ``plan`` is one plan shared by every cohort (leaves ``[L, W]``) or a
    :func:`stack_plans` batch of B shape-identical plans (leaves
    ``[B, L, W]``). Each level runs through
    :func:`repro_torch.core.algorithms.level_step_batched`: the B cohorts'
    lanes flattened cohort-major into one launch per kernel stage. Children
    merge into their parents in slot order, one add per slot for all
    cohorts at once (each cohort owns its own inbox rows), never with
    ``index_add_``. Every cohort's result is what :func:`execute` gives on
    its own plan and inputs. ``global_mask=None`` is zeros ``[B, d]``, so
    the TC algorithms always take the cohort form of the kernels. The
    result's leaves carry the cohort axis first.
    """
    b, k, d = grads.shape
    dev, dt = grads.device, grads.dtype
    if plan.num_clients != k:
        raise ValueError(f"plan has {plan.num_clients} clients, grads {k}")
    stacked = np.ndim(plan.node_id) == 3
    if stacked and plan.node_id.shape[0] != b:
        raise ValueError(f"stacked plan has {plan.node_id.shape[0]} "
                         f"cohorts, grads {b}")
    if global_mask is None:
        global_mask = torch.zeros((b, d), dtype=dt, device=dev)
    if participate is None:
        participate = torch.ones((b, k), dtype=dt, device=dev)
    participate = participate * torch.as_tensor(plan.alive, dtype=dt,
                                                device=dev)
    lvl = level_step_batched(cfg)

    # one zero dummy row (index K) per cohort backs the padding slots
    zrow = torch.zeros((b, 1, d), dtype=dt, device=dev)
    g_ext = torch.cat([grads, zrow], dim=1)
    e_ext = torch.cat([e, zrow], dim=1)
    w_ext = torch.cat([weights, weights.new_zeros((b, 1))], dim=1)
    p_ext = torch.cat([participate, participate.new_zeros((b, 1))], dim=1)
    q_ext = None
    if plan.q_budget is not None:
        qb = torch.as_tensor(np.asarray(plan.q_budget), dtype=torch.int32,
                             device=dev)
        q_ext = torch.cat([torch.broadcast_to(qb, (b, k)),
                           torch.zeros((b, 1), dtype=torch.int32,
                                       device=dev)], dim=1)

    cohort = torch.arange(b, device=dev)[:, None]

    def take_rows(x, ids):
        # ids [W] (shared plan) or [B, W] (stacked): per-cohort row gather
        return x[:, ids] if ids.dim() == 1 else x[cohort, ids]

    r_sinks = plan.num_sinks
    inbox = torch.zeros((b, k + r_sinks + 1, d), dtype=dt, device=dev)
    node_id = torch.as_tensor(np.asarray(plan.node_id, np.int64), device=dev)
    slot_mask = torch.as_tensor(plan.slot_mask, dtype=torch.float32,
                                device=dev)
    real = np.asarray(plan.slot_mask) > 0
    parent = np.asarray(plan.parent_row)
    e_lvl, st_lvl = [], []
    for li in range(plan.shape[-2]):
        ids = node_id[:, li] if stacked else node_id[li]
        mask = (slot_mask[:, li] if stacked
                else torch.broadcast_to(slot_mask[li], (b, ids.shape[-1])))
        gamma_out, e_new, stats = lvl(
            take_rows(g_ext, ids), take_rows(inbox, ids),
            take_rows(e_ext, ids), take_rows(w_ext, ids),
            take_rows(p_ext, ids), global_mask,
            None if q_ext is None else take_rows(q_ext, ids), mask)
        if stacked:
            # a slot real in any cohort: the others add their zero (padding)
            # output into the trash row
            rows = torch.as_tensor(parent[:, li].astype(np.int64),
                                   device=dev)
            for wi in np.flatnonzero(real[:, li].any(axis=0)):
                inbox[cohort[:, 0], rows[:, wi]] += gamma_out[:, wi]
        else:
            for wi in np.flatnonzero(real[li]):
                inbox[:, int(parent[li, wi])] += gamma_out[:, wi]
        e_lvl.append(e_new)
        st_lvl.append(stats)

    # level outputs [L, B, W, ...] in schedule order → [B, L·W, ...] →
    # each cohort's client index order
    pos = torch.as_tensor(np.asarray(plan.flat_pos, np.int64), device=dev)

    def reorder(levels):
        x = torch.stack(levels, dim=1)
        flat = x.reshape((b, -1) + x.shape[3:])
        return flat[:, pos] if pos.dim() == 1 else flat[cohort, pos]

    stats = HopStats(*(reorder(leaf) for leaf in zip(*st_lvl)))
    agg = inbox[:, k] if r_sinks == 1 else inbox[:, k:k + r_sinks]
    return RoundResult(aggregate=agg, e_new=reorder(e_lvl), stats=stats)
