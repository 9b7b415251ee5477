"""Topologies (chains + constellation trees), failure schedules, latency
models for the simulator (port of :mod:`repro.fed.topology`).

``ChainTopology`` is the paper's linear chain. ``TreeTopology`` wraps a
:class:`repro_torch.topo.graph.ConstellationGraph` plus a routing policy
and turns it into aggregation trees, re-routing around dead relays (tree
re-rooting: a failed relay's subtree is re-attached via surviving ISLs).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.topo.graph import ConstellationGraph
from repro_torch.topo.routing import shortest_path_tree, widest_path_tree
from repro_torch.topo.tree import AggTree


@dataclasses.dataclass
class ChainTopology:
    """Linear chain 1..K (node 1 adjacent to the PS)."""

    num_clients: int

    def order(self) -> np.ndarray:
        """Visiting order, farthest node first (identity chain)."""
        return np.arange(self.num_clients, dtype=np.int32)

    def healed_order(self, dead: list[int]) -> np.ndarray:
        """Chain with dead relays bypassed (neighbors splice together)."""
        return np.asarray([i for i in range(self.num_clients)
                           if i not in set(dead)], dtype=np.int32)

    def plan(self, *, pad_to: Optional[tuple] = None):
        """Compiled :class:`repro_torch.agg.AggPlan` of the identity chain."""
        from repro_torch.agg import compile_plan
        return compile_plan(self.num_clients, pad_to=pad_to)


@dataclasses.dataclass
class TreeTopology:
    """Constellation graph + routing policy → aggregation trees.

    ``routing``: "latency" / "hops" (shortest-path Dijkstra) or "widest"
    (max-bottleneck-bandwidth). ``dead`` entries are *client* indices
    (simulator row ids), mapped to graph nodes internally.
    """

    graph: ConstellationGraph
    routing: str = "latency"

    @property
    def num_clients(self) -> int:
        return self.graph.num_clients

    def tree(self, dead: tuple = ()) -> AggTree:
        """Aggregation tree over the surviving constellation.

        A dead relay is excluded from the graph before routing, so its
        subtree re-roots through surviving ISLs; the dead client itself is
        parked at the PS as an unreachable stub (zero bandwidth) — callers
        must zero its ``participate`` (see :func:`alive_mask`).
        """
        nodes = self.graph.client_nodes()
        exclude = [int(nodes[c]) for c in dead]
        if self.routing == "widest":
            return widest_path_tree(self.graph, exclude=exclude)
        return shortest_path_tree(self.graph, metric=self.routing,
                                  exclude=exclude)

    def plan(self, dead: tuple = (), *, pad_to: Optional[tuple] = None,
             bandwidth_aware: bool = False, cfg=None):
        """Compiled :class:`repro_torch.agg.AggPlan` of the routed tree.

        ``bandwidth_aware`` attaches per-client Top-Q budgets scaled by each
        uplink's bandwidth (needs ``cfg`` for the base budget). The plan's
        ``alive`` mask already zeros dead/stranded clients — ``execute``
        folds it into ``participate``.
        """
        from repro_torch.agg import bandwidth_budgets, compile_plan
        tree = self.tree(dead=dead)
        qb = None
        if bandwidth_aware:
            if cfg is None:
                raise ValueError("bandwidth_aware plans need cfg for the "
                                 "base Top-Q budget")
            qb = bandwidth_budgets(cfg, tree)
        return compile_plan(tree, pad_to=pad_to, q_budget=qb)

    def alive_mask(self, tree: AggTree, dead: tuple = ()) -> np.ndarray:
        """[K] 0/1 — zero for dead clients and stranded (unreachable) ones."""
        mask = np.ones((self.num_clients,), np.float32)
        if tree.reachable is not None:
            mask *= np.asarray(tree.reachable, np.float32)
        for c in dead:
            mask[c] = 0.0
        return mask


@dataclasses.dataclass
class FailureSchedule:
    """Deterministic failure/recovery schedule for reproducible tests.

    ``events[r] = ([fail_ids], [recover_ids])`` applied before round r.
    """

    num_clients: int
    events: dict

    def dead_at(self, r: int) -> list[int]:
        dead: set[int] = set()
        for rr in sorted(self.events):
            if rr > r:
                break
            fails, recovers = self.events[rr]
            dead |= set(fails)
            dead -= set(recovers)
        return sorted(dead)


@dataclasses.dataclass
class LatencyModel:
    """Log-normal per-client compute+uplink latency (straggler source)."""

    mean_s: float = 1.0
    sigma: float = 0.5
    seed: int = 0

    def sample(self, round_idx: int, k: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100003 + round_idx)
        return rng.lognormal(np.log(self.mean_s), self.sigma, size=k)
