"""Time-varying topologies: a schedule of plans sharing one ``(L, W)``
(port of :mod:`repro.agg.schedule`).

LEO constellations re-route continuously — the chain the PS sees this round
is not the tree it sees the next. A :class:`TopologySchedule` compiles a
sequence of topologies (explicit graphs/trees, or a base graph plus link
up/down events) into :class:`repro_torch.agg.plan.AggPlan`s padded to a
common ``(L, W)``, so every round of the schedule runs the level step at
one lane count W and one number of levels L, whatever the route. Padding
slots run the zero dummy row (``valid == 0`` lanes) and are never added.

Nested plans (a staged ``NestedTopology``) come with the nested plan
compiler, which the port does not have yet (ROADMAP A9); a schedule of them
raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.agg.plan import AggPlan, as_tree, compile_plan
from repro_torch.topo.graph import ConstellationGraph
from repro_torch.topo.routing import route_tree


_NESTED = ("nested plans are not ported yet (ROADMAP A9: agg/nested.py); "
           "schedule flat topologies")


def common_shape(plans: Iterable[AggPlan]) -> tuple:
    """Elementwise-max ``(L, W)`` over a set of flat plans (nested plans'
    per-stage signatures raise until ROADMAP A9)."""
    plans = list(plans)
    shapes = [p.shape for p in plans]
    if not shapes:
        raise ValueError("no plans")
    if isinstance(shapes[0][0], tuple):        # NestedPlan signatures
        raise NotImplementedError(_NESTED)
    return (max(s[0] for s in shapes), max(s[1] for s in shapes))


@dataclasses.dataclass(frozen=True)
class TopologySchedule:
    """Per-round aggregation plans, padded to one ``(L, W)``.

    ``plan_at(r)`` returns round r's plan: cyclic over the sequence when
    ``cyclic`` (a repeating orbital period), else clamped to the last entry
    (a one-shot event timeline). ``round_index[j]`` names the plan used at
    round j — distinct rounds may share a plan, so an N-round timeline with
    few distinct routes stores each route once.
    """

    plans: tuple                  # tuple[AggPlan, ...], one shape
    round_index: tuple            # per-round index into ``plans``
    cyclic: bool = True
    # optional raw topologies aligned with ``plans`` (AggTree or None) —
    # the link model :meth:`raw_at` hands out for crit-path timelines; ()
    # when the constructor had nothing to keep
    raws: tuple = ()

    def __post_init__(self):
        if not self.plans:
            raise ValueError("empty schedule")
        if self.raws and len(self.raws) != len(self.plans):
            raise ValueError("raws must align with plans")
        shape = self.plans[0].shape
        k = self.plans[0].num_clients
        budgeted = self.plans[0].q_budget is not None
        for p in self.plans:
            if p.shape != shape or p.num_clients != k:
                raise ValueError(
                    f"schedule plans must share one (L, W) and K; got "
                    f"{p.shape}/{p.num_clients} vs {shape}/{k}")
            if (p.q_budget is not None) != budgeted:
                # as in the reference: budgeted and unbudgeted rounds run
                # different node steps (dynamic vs fixed Top-Q)
                raise ValueError("schedule plans must either all carry a "
                                 "q_budget or none of them")
        if any(not 0 <= i < len(self.plans) for i in self.round_index):
            raise ValueError("round_index out of range")

    @property
    def shape(self) -> tuple:
        """The shared ``(L, W)`` of every plan of the schedule."""
        return self.plans[0].shape

    @property
    def num_clients(self) -> int:
        return self.plans[0].num_clients

    def __len__(self) -> int:
        return len(self.round_index)

    def _index_at(self, r: int) -> int:
        n = len(self.round_index)
        j = r % n if self.cyclic else min(r, n - 1)
        return self.round_index[j]

    def plan_at(self, r: int) -> AggPlan:
        return self.plans[self._index_at(r)]

    def raw_at(self, r: int):
        """Round r's raw topology (an :class:`~repro_torch.topo.tree.AggTree`
        carrying the link model), if the constructor kept it; None
        otherwise."""
        return self.raws[self._index_at(r)] if self.raws else None

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_topologies(cls, topologies: Sequence, *,
                        num_clients: Optional[int] = None,
                        q_budgets: Optional[Sequence] = None,
                        round_index: Optional[Sequence] = None,
                        cyclic: bool = True) -> "TopologySchedule":
        """One plan per topology (graph, tree, chain order, int K, or
        anything :func:`~repro_torch.agg.plan.compile_plan` takes), padded
        to the common shape. ``round_index`` maps rounds onto the topology
        list (default: one round each)."""
        if q_budgets is None:
            q_budgets = [None] * len(topologies)
        if any(hasattr(t, "nested_stages") for t in topologies):
            raise NotImplementedError(_NESTED)
        plans = [compile_plan(t, num_clients=num_clients, q_budget=qb)
                 for t, qb in zip(topologies, q_budgets)]
        raws = tuple(as_tree(t, num_clients) for t in topologies)
        shape = common_shape(plans)
        return cls(plans=tuple(p.pad(shape) for p in plans),
                   round_index=(tuple(range(len(plans)))
                                if round_index is None
                                else tuple(int(i) for i in round_index)),
                   cyclic=cyclic, raws=raws)

    @classmethod
    def from_link_events(cls, graph: ConstellationGraph, events: dict, *,
                         rounds: int, routing: str = "latency",
                         cyclic: bool = False) -> "TopologySchedule":
        """A base constellation plus a link up/down timeline.

        ``events[r] = ([down_links], [up_links])`` applied before round r,
        cumulative (a link stays down until an up event restores it); links
        are ``(u, v)`` node pairs. Each distinct down-set is routed and
        compiled once; routing around a lost link re-roots the affected
        subtree, and clients a partition strands become non-participating
        stubs (``plan.alive`` zeros them).
        """
        down: set = set()
        compiled: dict = {}
        plans: list = []
        raws: list = []
        round_index = []
        for r in range(rounds):
            if r in events:
                downs, ups = events[r]
                down |= {(min(int(u), int(v)), max(int(u), int(v)))
                         for u, v in downs}
                down -= {(min(int(u), int(v)), max(int(u), int(v)))
                         for u, v in ups}
            key = frozenset(down)
            if key not in compiled:
                g = graph.without_links(down) if down else graph
                compiled[key] = len(plans)
                tree = route_tree(g, routing)
                raws.append(tree)
                plans.append(compile_plan(tree))
            round_index.append(compiled[key])
        shape = common_shape(plans)
        return cls(plans=tuple(p.pad(shape) for p in plans),
                   round_index=tuple(round_index), cyclic=cyclic,
                   raws=tuple(raws))
