"""Nested aggregation plans: hierarchical (staged) aggregation (port of
:mod:`repro.agg.nested`).

The paper's multi-hop IA recursion is topology-agnostic: a two-stage
pod ring is the same algorithm run on a 2-level tree of trees, and the
satellite deployments make *cluster-then-relay* aggregation the primary
shape — aggregate inside each cluster over cheap local links, then relay
the per-cluster partials to the PS over the scarce inter-cluster links.

A :class:`NestedPlan` is an ordered stack of
:class:`~repro_torch.agg.plan.AggPlan` stages. Stage s is a *forest* plan
(``num_sinks = R_s``): R_s independent trees over that stage's units, each
delivering its partial aggregate to a distinct sink row. The inter-stage
wiring is the sink numbering — stage s's sink c becomes stage s+1's client
c, folded with **weight 1** (client weights were already applied at stage
0) and its **own error-feedback tier**. Each stage reports its own
:class:`~repro_torch.core.algorithms.HopStats`, so the intra-cluster and
inter-cluster wire split is measured, not modeled.

``compile_nested`` lowers a stage spec — or a routed
:class:`~repro_torch.topo.routing.NestedTopology` from the cluster-aware
router — into a NestedPlan; :func:`execute_nested` runs one round through
:func:`repro_torch.agg.plan.execute`, one stage after another, on the
device of the gradients it is given. Plans are numpy on the host, as flat
plans are. :class:`ClusteredStage` is the per-cluster view of a forest
stage that the reference's multi-device lowering selects from (ROADMAP
A12); here :meth:`NestedPlan.client_alive` and :attr:`NestedPlan.shape`
read it.

Semantics note: staged CL-SIA applies Top-Q once per stage, so the
composition is not bit-identical to the flat chain, but both are instances
of the paper's algorithm on a multi-level topology; EF at every tier keeps
the mass conserved per stage. DENSE_IA composition is the exact sum.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.agg.plan import AggPlan, as_tree, compile_plan, execute
from repro_torch.core.algorithms import AggConfig, HopStats
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.topo.tree import PS, AggTree, path_tree

Tensor = torch.Tensor


def _ring_chain_tree(num_ranks: int) -> AggTree:
    """The rotated ring's chain (reversed path tree): rank r's parent is
    r + 1, the last rank delivers to the PS."""
    return AggTree(parent=tuple(range(1, num_ranks)) + (PS,))


# ---------------------------------------------------------------------------
# Forest schedule (multi-sink AggPlan) construction
# ---------------------------------------------------------------------------

def _forest_plan(parent: np.ndarray, sink: np.ndarray, *, num_sinks: int,
                 alive: np.ndarray,
                 q_budget: Optional[np.ndarray]) -> AggPlan:
    """Level-schedule a forest: ``parent[i]`` ∈ 0..K−1 or :data:`PS`;
    roots deliver to sink row ``k + sink[i]``. Deepest level first, as
    :func:`repro_torch.topo.tree.build_schedule` does for one sink."""
    k = len(parent)
    depth = np.zeros((k,), np.int64)
    for i in range(k):
        d, node, hops = 1, i, 0
        while parent[node] != PS:
            node = int(parent[node])
            if not 0 <= node < k:
                raise ValueError(f"parent index {node} out of range")
            d += 1
            hops += 1
            if hops > k:
                raise ValueError("cycle in aggregation forest")
        depth[i] = d
    lmax = int(depth.max()) if k else 0
    levels = [np.where(depth == lv)[0] for lv in range(lmax, 0, -1)]
    w = max((len(lv) for lv in levels), default=1)

    node_id = np.full((lmax, w), k, np.int32)
    slot_mask = np.zeros((lmax, w), np.float32)
    parent_row = np.full((lmax, w), k + num_sinks, np.int32)
    flat_pos = np.zeros((k,), np.int64)
    for li, members in enumerate(levels):
        for wi, node in enumerate(members):
            node_id[li, wi] = node
            slot_mask[li, wi] = 1.0
            p = int(parent[node])
            parent_row[li, wi] = (k + int(sink[node])) if p == PS else p
            flat_pos[node] = li * w + wi
    return AggPlan(node_id=node_id, slot_mask=slot_mask,
                   parent_row=parent_row,
                   flat_pos=flat_pos.astype(np.int32),
                   alive=np.asarray(alive, np.float32), q_budget=q_budget,
                   num_clients=k, num_sinks=num_sinks)


# ---------------------------------------------------------------------------
# Clustered stage form (the multi-device lowering's view of a forest stage)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClusteredStage:
    """Per-cluster stacked single-sink plans of one forest stage.

    Leaves carry a leading cluster axis: ``node_id[c]`` etc. is cluster c's
    local :class:`AggPlan` (over ``num_units`` local nodes, local sink row
    ``num_units``, trash ``num_units + 1``); ``members[c, m]`` is the
    global unit index of local node m (pad = the stage's unit count).
    ``flat_pos`` of unit-padding locals is a placeholder (0) — those locals
    never appear in the schedule. :meth:`mesh_aligned` tells whether
    cluster c is exactly units ``c·M .. c·M + M − 1``, the layout a
    (pod, data) device mesh requires.
    """

    node_id: np.ndarray        # [C, L, W] int32 (local ids; pad = M)
    slot_mask: np.ndarray      # [C, L, W] float32
    parent_row: np.ndarray     # [C, L, W] int32 (local; M = sink, M+1 trash)
    flat_pos: np.ndarray       # [C, M] int32
    alive: np.ndarray          # [C, M] float32
    q_budget: Optional[np.ndarray]   # [C, M] int32
    members: np.ndarray        # [C, M] int32 (global unit index; pad = K)
    num_units: int = 0         # M

    def mesh_aligned(self) -> bool:
        m = np.asarray(self.members)
        return bool(np.all(m.reshape(-1) == np.arange(m.size)))

    @property
    def num_clusters(self) -> int:
        return int(self.node_id.shape[0])

    @property
    def shape(self) -> tuple:
        return tuple(self.node_id.shape)

    def subplan(self, c: int) -> AggPlan:
        """Cluster c's local single-sink plan."""
        take = lambda a: None if a is None else np.asarray(a)[int(c)]  # noqa: E731
        return AggPlan(node_id=take(self.node_id),
                       slot_mask=take(self.slot_mask),
                       parent_row=take(self.parent_row),
                       flat_pos=take(self.flat_pos), alive=take(self.alive),
                       q_budget=take(self.q_budget),
                       num_clients=self.num_units, num_sinks=1)

    def pad(self, shape: tuple) -> "ClusteredStage":
        """Re-pad every cluster's (L, W) — the schedule-sharing companion
        of :meth:`AggPlan.pad`."""
        c, big_l, big_w = shape
        if (c, big_l, big_w) == self.shape:
            return self
        if c != self.shape[0]:
            raise ValueError(f"cluster count {self.shape[0]} != {c}")
        plans = [self.subplan(i).pad((big_l, big_w)) for i in range(c)]
        return ClusteredStage(
            node_id=np.stack([p.node_id for p in plans]),
            slot_mask=np.stack([p.slot_mask for p in plans]),
            parent_row=np.stack([p.parent_row for p in plans]),
            flat_pos=np.stack([p.flat_pos for p in plans]),
            alive=self.alive, q_budget=self.q_budget, members=self.members,
            num_units=self.num_units)


def _pad_units(plan: AggPlan, m_big: int) -> AggPlan:
    """Grow a single-sink plan from m to M local nodes. The added locals
    never appear in the schedule; only the dummy/sink/trash row ids shift
    from (m, m, m+1) to (M, M, M+1)."""
    m = plan.num_clients
    if m == m_big:
        return plan
    node_id = np.where(np.asarray(plan.node_id) == m, m_big,
                       plan.node_id).astype(np.int32)
    par = np.asarray(plan.parent_row)
    parent_row = np.where(par == m, m_big,
                          np.where(par == m + 1, m_big + 1,
                                   par)).astype(np.int32)
    pad = m_big - m
    qb = (None if plan.q_budget is None
          else np.concatenate([np.asarray(plan.q_budget, np.int32),
                               np.zeros((pad,), np.int32)]))
    return AggPlan(
        node_id=node_id, slot_mask=plan.slot_mask, parent_row=parent_row,
        flat_pos=np.concatenate([np.asarray(plan.flat_pos, np.int32),
                                 np.zeros((pad,), np.int32)]),
        alive=np.concatenate([np.asarray(plan.alive, np.float32),
                              np.zeros((pad,), np.float32)]),
        q_budget=qb, num_clients=m_big, num_sinks=1)


# ---------------------------------------------------------------------------
# NestedPlan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NestedPlan:
    """An ordered stack of forest :class:`AggPlan` stages (see module doc).

    ``stages[s]`` is the stage-s forest over ``stage_units[s]`` units with
    ``num_sinks == stage_units[s+1]`` (1 for the last stage — the PS).
    ``clustered[s]`` (stages 0..S−2) is the same forest in per-cluster
    stacked form. Every leaf is a numpy array on the host.
    """

    stages: tuple                 # tuple[AggPlan, ...]
    clustered: tuple = ()         # tuple[ClusteredStage, ...], len S−1

    def __post_init__(self):
        if not self.stages:
            raise ValueError("nested plan needs at least one stage")
        for s in range(len(self.stages) - 1):
            r, nxt = self.stages[s].num_sinks, self.stages[s + 1].num_clients
            if r != nxt:
                raise ValueError(
                    f"stage {s} has {r} sinks but stage {s + 1} has {nxt} "
                    f"clients — the sink numbering is the wiring map")
        if self.stages[-1].num_sinks != 1:
            raise ValueError("the last stage must aggregate to one PS sink")

    @property
    def num_clients(self) -> int:
        return self.stages[0].num_clients

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def stage_units(self) -> tuple:
        return tuple(s.num_clients for s in self.stages)

    @property
    def q_budget(self):
        """Stage-0 per-client budgets (TopologySchedule compatibility)."""
        return self.stages[0].q_budget

    def client_alive(self, device: Optional[DeviceLike] = None):
        """Effective [K] client aliveness: a client's mass reaches the PS
        only if the client AND its whole relay chain of cluster units are
        alive (a quotient-unreachable cluster forwards nothing — its
        clients must not be counted in the PS weight denominator).

        Folded down through ``clustered[s].members`` in numpy; a float32
        numpy array, or a tensor on ``device`` when one is given.
        """
        alive = np.asarray(self.stages[-1].alive, np.float32)
        for s in range(self.num_stages - 2, -1, -1):
            members = np.asarray(self.clustered[s].members)     # [C, M]
            k_s = self.stages[s].num_clients
            # the pad index k_s is a dummy row, dropped after the scatter
            down = np.zeros((k_s + 1,), np.float32)
            down[members.reshape(-1)] = np.repeat(alive, members.shape[1])
            alive = np.asarray(self.stages[s].alive, np.float32) * down[:k_s]
        if device is None:
            return alive
        return torch.as_tensor(alive, device=resolve_device(device))

    @property
    def shape(self) -> tuple:
        """Per-stage shape signature: each stage's padded (L, W), with the
        clustered form's (C, L, W) appended where present."""
        sig = []
        for s, st in enumerate(self.stages):
            entry = st.shape
            if s < len(self.clustered):
                entry = entry + self.clustered[s].shape
            sig.append(entry)
        return tuple(sig)

    def pad(self, shape: tuple) -> "NestedPlan":
        """Re-pad every stage to the given :attr:`shape` signature —
        bit-exact, the schedule-sharing companion of :meth:`AggPlan.pad`."""
        if tuple(shape) == self.shape:
            return self
        if len(shape) != len(self.stages):
            raise ValueError(f"shape has {len(shape)} stages, plan has "
                             f"{len(self.stages)}")
        stages, clustered = [], []
        for s, (st, sig) in enumerate(zip(self.stages, shape)):
            stages.append(st.pad(tuple(sig[:2])))
            if s < len(self.clustered):
                clustered.append(self.clustered[s].pad(tuple(sig[2:])))
        return NestedPlan(stages=tuple(stages), clustered=tuple(clustered))


def nested_common_shape(plans) -> tuple:
    """Elementwise-max per-stage shape signature over nested plans."""
    shapes = [p.shape for p in plans]
    if not shapes:
        raise ValueError("no plans")
    n = len(shapes[0])
    if any(len(s) != n for s in shapes):
        raise ValueError("nested plans must have the same stage count")
    out = []
    for s in range(n):
        entries = [sh[s] for sh in shapes]
        if len({len(e) for e in entries}) != 1:
            raise ValueError("nested plans must agree on clustered-form "
                             "presence per stage")
        out.append(tuple(max(e[i] for e in entries)
                         for i in range(len(entries[0]))))
    return tuple(out)


# ---------------------------------------------------------------------------
# compile_nested
# ---------------------------------------------------------------------------

def _local_tree(topo: Any, m: int) -> AggTree:
    if topo is None:
        return path_tree(m)       # members[0] adjacent to the sink
    if isinstance(topo, AggTree):
        tree = topo
    elif isinstance(topo, int):
        tree = path_tree(topo)
    else:
        tree = as_tree(topo, m)
    if tree.num_clients != m:
        raise ValueError(f"cluster tree has {tree.num_clients} nodes for "
                         f"{m} members")
    return tree


def _cluster_spec(spec) -> tuple:
    """A cluster entry → ``(members, topology)``: a ``(members, topo)``
    pair, or bare members (the chain in member order)."""
    if (isinstance(spec, tuple) and len(spec) == 2
            and not isinstance(spec[0], (int, np.integer))):
        return spec
    return spec, None


def _compile_stage(clusters: Sequence, k: int,
                   q_budget: Optional[np.ndarray],
                   build_clustered: bool):
    """One stage spec → (forest AggPlan, Optional[ClusteredStage]).

    ``clusters`` is ``[(members, topology), ...]``: members are unit
    indices of *this* stage, topology an :class:`AggTree` over
    ``len(members)`` local nodes (None → the paper chain in member order,
    members[0] adjacent to the sink). Members must partition 0..k−1.
    """
    num_sinks = len(clusters)
    parent = np.full((k,), PS, np.int64)
    sink = np.zeros((k,), np.int64)
    alive = np.ones((k,), np.float32)
    seen: set = set()
    local_plans, member_rows = [], []
    for c, spec in enumerate(clusters):
        members, topo = _cluster_spec(spec)
        members = [int(i) for i in np.asarray(members, np.int64).reshape(-1)]
        if not members:
            raise ValueError(f"cluster {c} is empty")
        dup = seen.intersection(members)
        if dup:
            raise ValueError(f"units {sorted(dup)} appear in two clusters")
        seen.update(members)
        tree = _local_tree(topo, len(members))
        for i, g in enumerate(members):
            p = tree.parent[i]
            parent[g] = PS if p == PS else members[p]
            sink[g] = c
            if tree.reachable is not None and not tree.reachable[i]:
                alive[g] = 0.0
        if build_clustered:
            qb_c = (None if q_budget is None
                    else np.asarray(q_budget, np.int32)[members])
            local_plans.append(compile_plan(tree, q_budget=qb_c))
            member_rows.append(members)
    if seen != set(range(k)):
        missing = sorted(set(range(k)) - seen)
        raise ValueError(f"clusters must partition 0..{k - 1}; missing "
                         f"{missing}")

    plan = _forest_plan(parent, sink, num_sinks=num_sinks, alive=alive,
                        q_budget=(None if q_budget is None
                                  else np.asarray(q_budget,
                                                  np.int32).reshape(-1)))
    if not build_clustered:
        return plan, None

    m_big = max(len(m) for m in member_rows)
    shape = (max(p.shape[0] for p in local_plans),
             max(p.shape[1] for p in local_plans))
    padded = [_pad_units(p.pad(shape), m_big) for p in local_plans]
    members = np.full((num_sinks, m_big), k, np.int32)
    for c, row in enumerate(member_rows):
        members[c, :len(row)] = row
    clustered = ClusteredStage(
        node_id=np.stack([p.node_id for p in padded]),
        slot_mask=np.stack([p.slot_mask for p in padded]),
        parent_row=np.stack([p.parent_row for p in padded]),
        flat_pos=np.stack([p.flat_pos for p in padded]),
        alive=np.stack([p.alive for p in padded]),
        q_budget=(None if q_budget is None
                  else np.stack([np.asarray(p.q_budget, np.int32)
                                 for p in padded])),
        members=members, num_units=m_big)
    return plan, clustered


def compile_nested(topology: Any, *,
                   num_clients: Optional[int] = None,
                   pad_to: Optional[tuple] = None,
                   q_budget: Optional[np.ndarray] = None) -> NestedPlan:
    """Lower a staged topology to its canonical :class:`NestedPlan`.

    ``topology`` is one of

    * a :class:`NestedPlan` — returned (re-padded when ``pad_to``);
    * a :class:`repro_torch.topo.routing.NestedTopology` — the
      cluster-aware router's output (clusters + intra trees + inter relay
      tree);
    * a stage spec: a sequence of stages, each a sequence of clusters
      ``(members, topo)`` (``topo`` None → chain in member order). Stage
      s's clusters partition stage s's units; stage s+1's unit c is stage
      s's cluster c; the last stage has exactly one cluster (the PS tree).

    ``q_budget`` attaches stage-0 per-client budgets. ``pad_to`` is a
    :attr:`NestedPlan.shape` signature for schedule sharing.
    """
    if isinstance(topology, NestedPlan):
        return topology if pad_to is None else topology.pad(pad_to)
    if hasattr(topology, "nested_stages"):      # NestedTopology
        topology = topology.nested_stages()
    stages_spec = list(topology)
    if not stages_spec:
        raise ValueError("empty stage spec")
    if len(stages_spec[-1]) != 1:
        raise ValueError("the last stage must be a single cluster rooted "
                         "at the PS")

    k = num_clients
    if k is None:
        k = 1 + max(int(i) for spec in stages_spec[0]
                    for i in np.asarray(_cluster_spec(spec)[0],
                                        np.int64).reshape(-1))
    stages, clustered = [], []
    for s, spec in enumerate(stages_spec):
        last = s == len(stages_spec) - 1
        plan, cl = _compile_stage(spec, k, q_budget if s == 0 else None,
                                  build_clustered=not last)
        stages.append(plan)
        if cl is not None:
            clustered.append(cl)
        k = plan.num_sinks
    nested = NestedPlan(stages=tuple(stages), clustered=tuple(clustered))
    if pad_to is not None:
        nested = nested.pad(tuple(pad_to))
    return nested


def pod_ring_nested(k_pod: int, k_data: int, *,
                    q_budget: Optional[np.ndarray] = None) -> NestedPlan:
    """The two-stage pod ring as a nested plan (chain × chain).

    Stage 0: one rotated-ring chain per pod over its ``k_data`` members
    (client ``p·K_d + r`` ↔ rank ``(p, r)``); stage 1: the ring chain over
    the ``k_pod`` pod partials.
    """
    intra = _ring_chain_tree(k_data)
    stage0 = [(tuple(range(p * k_data, (p + 1) * k_data)), intra)
              for p in range(k_pod)]
    stage1 = [(tuple(range(k_pod)), _ring_chain_tree(k_pod))]
    return compile_nested([stage0, stage1],
                          num_clients=k_pod * k_data, q_budget=q_budget)


def as_nested(topology: Any, num_clients: Optional[int] = None
              ) -> Optional[NestedPlan]:
    """Coerce nested-shaped topologies to a :class:`NestedPlan`; ``None``
    for everything else (flat topologies keep their own paths)."""
    if isinstance(topology, NestedPlan):
        return topology
    if hasattr(topology, "nested_stages"):
        return compile_nested(topology, num_clients=num_clients)
    return None


# ---------------------------------------------------------------------------
# execute_nested — one staged round
# ---------------------------------------------------------------------------

class NestedResult(NamedTuple):
    aggregate: Tensor     # [d] what the PS receives after the last stage
    e_new: Tensor         # [K, d] stage-0 (client) EF, client index order
    stage_e_new: tuple    # per upper stage: [K_s, d] EF tier
    stats: HopStats       # stage-0 per-client stats, leaves [K]
    stage_stats: tuple    # per upper stage: HopStats, leaves [K_s]


def zero_stage_ef(nested: NestedPlan, d: int,
                  device: DeviceLike = None,
                  dtype: torch.dtype = torch.float32) -> tuple:
    """Fresh upper-tier EF buffers, one [K_s, d] tensor per stage ≥ 1, on
    ``device`` (``None`` → ``cuda``)."""
    dev = resolve_device(device)
    return tuple(torch.zeros((k, d), dtype=dtype, device=dev)
                 for k in nested.stage_units[1:])


def execute_nested(
    cfg: AggConfig,
    nested: NestedPlan,
    grads: Tensor,                 # [K, d] per-client effective gradients
    e: Tensor,                     # [K, d] client-level EF memory
    weights: Tensor,               # [K]    D_k
    *,
    stage_e: Optional[Sequence[Tensor]] = None,  # EF tiers, stages ≥ 1
    global_mask: Optional[Tensor] = None,        # [d] TCS mask m^t
    participate: Optional[Tensor] = None,        # [K] 0/1 straggler mask
    stage_cfgs: Optional[Sequence[AggConfig]] = None,
) -> NestedResult:
    """One staged aggregation round over a compiled :class:`NestedPlan`.

    Stage 0 is :func:`repro_torch.agg.plan.execute` on the client forest
    (same contract, incl. ``participate``/``q_budget``/straggler
    semantics); every later stage re-enters ``execute`` with the previous
    stage's sink rows as its "gradients", weight 1, and that stage's EF
    tier — the paper's recursion one level up, through the same level
    steps (and kernels). The same ``global_mask`` goes to every stage.
    ``stage_cfgs`` optionally overrides the AggConfig per stage (e.g. a
    larger inter-cluster budget); default: ``cfg`` for every tier. Runs on
    the device of ``grads``.
    """
    k, d = grads.shape
    if nested.num_clients != k:
        raise ValueError(f"nested plan has {nested.num_clients} clients, "
                         f"grads {k}")
    n_stages = nested.num_stages
    cfgs = list(stage_cfgs) if stage_cfgs is not None else [cfg] * n_stages
    if len(cfgs) != n_stages:
        raise ValueError(f"stage_cfgs has {len(cfgs)} entries for "
                         f"{n_stages} stages")
    if stage_e is None:
        stage_e = zero_stage_ef(nested, d, grads.device, grads.dtype)
    stage_e = tuple(stage_e)
    if len(stage_e) != n_stages - 1:
        raise ValueError(f"stage_e needs {n_stages - 1} EF tiers, got "
                         f"{len(stage_e)}")

    res0 = execute(cfgs[0], nested.stages[0], grads, e, weights,
                   global_mask=global_mask, participate=participate)
    agg = res0.aggregate
    if nested.stages[0].num_sinks == 1:
        agg = agg[None]            # a one-sink forest keeps its row axis
    stage_e_new, stage_stats = [], []
    for s in range(1, n_stages):
        plan = nested.stages[s]
        ones = torch.ones((plan.num_clients,), dtype=grads.dtype,
                          device=grads.device)
        res = execute(cfgs[s], plan, agg, stage_e[s - 1], ones,
                      global_mask=global_mask)
        stage_e_new.append(res.e_new)
        stage_stats.append(res.stats)
        agg = res.aggregate
        if plan.num_sinks == 1:
            agg = agg[None]
    return NestedResult(aggregate=agg[0], e_new=res0.e_new,
                        stage_e_new=tuple(stage_e_new), stats=res0.stats,
                        stage_stats=tuple(stage_stats))
