"""Tree-structured sparse incremental aggregation (port of
:mod:`repro.topo.tree`).

An :class:`AggTree` is an aggregation tree over clients ``0..K-1`` rooted at
the parameter server (parent sentinel :data:`PS`). Node k receives the *sum*
of its children's partial aggregates γ_c as its incoming γ, applies the
configured Algorithm 1–5 node step (EF included), and forwards γ_k to its
parent; the PS receives the sum over its children. On a path graph this is
exactly the chain.

Nodes are grouped by depth into levels (:func:`build_schedule`); the
executor :func:`repro_torch.agg.plan.execute` walks the levels deepest
first and runs every node of a level as one lane of a batched level step.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.algorithms import AggConfig, HopStats

Tensor = torch.Tensor

#: ``parent[i] == PS`` marks a client whose parent is the parameter server.
PS = -1


@dataclasses.dataclass(frozen=True)
class AggTree:
    """Aggregation tree over clients 0..K−1 (hashable).

    ``parent[i]`` is the client index of i's parent, or :data:`PS`.
    ``uplink_bw_bps`` / ``uplink_latency_s`` describe client i's link to its
    parent (0 when unknown); ``reachable[i]`` is False for stranded stubs
    parked at the PS after a partition (their ``participate`` must be 0).
    """

    parent: tuple
    uplink_bw_bps: Optional[tuple] = None
    uplink_latency_s: Optional[tuple] = None
    reachable: Optional[tuple] = None

    def __post_init__(self):
        # compute depths eagerly: validates acyclicity/range at build time
        # and avoids caching (trees are built per round under failures)
        k = len(self.parent)
        depth = [0] * k
        for i, p in enumerate(self.parent):
            d, node, hops = 1, i, 0
            while self.parent[node] != PS:
                node = self.parent[node]
                if not 0 <= node < k:
                    raise ValueError(f"parent index {node} out of range")
                d += 1
                hops += 1
                if hops > k:
                    raise ValueError("cycle in aggregation tree")
            depth[i] = d
        object.__setattr__(self, "_depth", tuple(depth))

    @property
    def num_clients(self) -> int:
        return len(self.parent)

    def depths(self) -> np.ndarray:
        """depth[i] = #links from client i to the PS (≥ 1)."""
        return np.asarray(self._depth, np.int64)

    def children(self) -> list:
        """children[i] = client indices whose parent is i."""
        ch: list = [[] for _ in range(self.num_clients)]
        for i, p in enumerate(self.parent):
            if p != PS:
                ch[p].append(i)
        return ch

    def ps_children(self) -> list:
        return [i for i, p in enumerate(self.parent) if p == PS]

    def subtree_sizes(self) -> np.ndarray:
        """size[i] = #clients in the subtree rooted at i (incl. i itself).

        On a path graph this is (K, K−1, …, 1) from the PS outward — the
        per-hop aggregate counts of the chain cost model.
        """
        k = self.num_clients
        size = np.ones((k,), np.int64)
        order = np.argsort(-self.depths())        # deepest first
        for i in order:
            p = self.parent[i]
            if p != PS:
                size[p] += size[i]
        return size

    def max_depth(self) -> int:
        return int(self.depths().max()) if self.num_clients else 0


def path_tree(num_clients: int) -> AggTree:
    """The paper chain as a tree: client 0 at the PS, i's parent is i−1."""
    return AggTree(parent=tuple([PS] + list(range(num_clients - 1))))


def star_tree(num_clients: int) -> AggTree:
    """Every client a direct child of the PS (depth-1 FedAvg topology)."""
    return AggTree(parent=(PS,) * num_clients)


# ---------------------------------------------------------------------------
# Level schedule
# ---------------------------------------------------------------------------

class TreeSchedule(NamedTuple):
    """Static level schedule: L levels × W slots, deepest level first.

    ``node_id[l, w]`` is the client run in slot w of level l (padding slots
    hold K, a zero dummy row); ``slot_mask`` is 1.0 for real slots;
    ``parent_row[l, w]`` is the inbox row receiving that slot's γ (client
    index, K for the PS, K+1 trash row for padding). ``flat_pos[k]`` is
    client k's flattened (level, slot) position, for mapping level outputs
    back to client index order.
    """

    node_id: np.ndarray       # [L, W] int32
    slot_mask: np.ndarray     # [L, W] float32
    parent_row: np.ndarray    # [L, W] int32
    flat_pos: np.ndarray      # [K] int64


def build_schedule(tree: AggTree) -> TreeSchedule:
    k = tree.num_clients
    depth = tree.depths()
    lmax = tree.max_depth()
    levels = [np.where(depth == l)[0] for l in range(lmax, 0, -1)]
    w = max((len(lv) for lv in levels), default=1)

    node_id = np.full((lmax, w), k, np.int32)             # pad → dummy row K
    slot_mask = np.zeros((lmax, w), np.float32)
    parent_row = np.full((lmax, w), k + 1, np.int32)      # pad → trash row
    flat_pos = np.zeros((k,), np.int64)
    for li, members in enumerate(levels):
        for wi, node in enumerate(members):
            node_id[li, wi] = node
            slot_mask[li, wi] = 1.0
            p = tree.parent[node]
            parent_row[li, wi] = k if p == PS else p
            flat_pos[node] = li * w + wi
    return TreeSchedule(node_id=node_id, slot_mask=slot_mask,
                        parent_row=parent_row, flat_pos=flat_pos)


# ---------------------------------------------------------------------------
# run_tree
# ---------------------------------------------------------------------------

class TreeResult(NamedTuple):
    aggregate: Tensor      # what the PS receives (Σ over its children), [d]
    e_new: Tensor          # updated EF memory, [K, d] (client index order)
    stats: HopStats       # per-hop stats, leaves [K] (client index order)


def run_tree(
    cfg: AggConfig,
    tree: AggTree,
    grads: Tensor,                 # [K, d] per-client effective gradients g_k
    e: Tensor,                     # [K, d] EF memory
    weights: Tensor,               # [K]    D_k
    *,
    global_mask: Optional[Tensor] = None,  # [d] TCS mask m^t (TC algorithms)
    participate: Optional[Tensor] = None,  # [K] 0/1 straggler mask
) -> TreeResult:
    """One aggregation round over an arbitrary tree (chain generalization).

    Same contract as :func:`repro_torch.core.chain.run_chain` plus the
    ``tree``; a thin wrapper over :func:`repro_torch.agg.plan.execute`,
    which folds the tree's stranded-stub mask (``reachable``) into
    ``participate``. Runs on the device of ``grads``.
    """
    # function-level import: repro_torch.agg.plan imports AggTree from here
    from repro_torch.agg.plan import compile_plan, execute

    res = execute(cfg, compile_plan(tree), grads, e, weights,
                  global_mask=global_mask, participate=participate)
    return TreeResult(aggregate=res.aggregate, e_new=res.e_new,
                      stats=res.stats)


# ---------------------------------------------------------------------------
# Latency model (per-link attributes → round time)
# ---------------------------------------------------------------------------

def round_latency_s(tree: AggTree, bits_per_hop: Sequence[float]) -> float:
    """Critical-path aggregation latency of one round.

    Node i becomes ready at ``max(children ready) + serialize + propagate``
    over its uplink; the round ends when the last PS child arrives. Uses the
    tree's per-link attributes (zero-bandwidth stubs are skipped).
    """
    if tree.uplink_bw_bps is None or tree.uplink_latency_s is None:
        raise ValueError("tree has no link attributes (built by hand?)")
    ready = [0.0] * tree.num_clients
    order = np.argsort(-tree.depths())
    for i in order:
        i = int(i)
        bw = tree.uplink_bw_bps[i]
        if bw <= 0:
            continue
        tx = float(bits_per_hop[i]) / bw + tree.uplink_latency_s[i]
        ready[i] += tx
        p = tree.parent[i]
        if p != PS:
            ready[p] = max(ready[p], ready[i])
    ps_kids = [i for i in tree.ps_children()
               if (tree.uplink_bw_bps[i] or 0) > 0]
    return max((ready[i] for i in ps_kids), default=0.0)
