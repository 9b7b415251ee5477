"""Lower a :class:`~repro_torch.scenario.spec.Scenario` onto the round engine
(port of :mod:`repro.scenario.compile`).

:func:`compile_scenario` realizes every fault timeline host-side and
produces a :class:`CompiledScenario` made only of objects the system
already consumes:

* a padded :class:`~repro_torch.agg.schedule.TopologySchedule` — each distinct
  (down-links, dead-nodes, bandwidth-factors) configuration is routed and
  compiled **once**, then shared by every round it covers, and all plans
  are padded to one ``(L, W)`` so every round of the scenario meets one
  input signature (the trace counter proves it);
* a ``[rounds, K]`` participation matrix — crash windows, straggler draws
  (:class:`~repro_torch.runtime.fault.StragglerModel` drawing from
  :func:`straggler_generator`), and deadline misses
  (:class:`~repro_torch.fed.topology.LatencyModel` +
  :func:`~repro_torch.runtime.fault.deadline_mask`), all materialized at compile
  time so the run itself draws no randomness;
* per-round ``q_budget`` arrays (``bandwidth_aware``:
  :func:`repro_torch.agg.bandwidth_budgets` against the round's — possibly
  degraded — routed tree, attached to every plan so the schedule keeps one
  pytree structure);
* the realized event stream (window dicts) the simulator writes into the
  trace as ``track="scenario"`` span records.

Because everything stochastic is realized here from spec-carried seeds,
compiling the same spec twice yields bit-identical participation and
schedules — the foundation of deterministic replay.

Stragglers are the one place the reference draws with ``jax.random``
(``fold_in(PRNGKey(seed), round)``). The port draws from a CPU
``torch.Generator`` seeded from the window's ``seed`` and the round
(:func:`straggler_generator`): the process and its determinism are the
same, the realized masks differ from the reference's. Tests that compare
the packages feed the reference's participation matrix in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.scenario.spec import Scenario


@dataclasses.dataclass(frozen=True)
class CompiledScenario:
    """A scenario lowered onto schedule + participation + events."""

    spec: Scenario
    schedule: object              # TopologySchedule (flat or nested plans)
    participation: np.ndarray     # [rounds, K] float32 in {0., 1.}
    events: tuple                 # realized window dicts, round order

    @property
    def rounds(self) -> int:
        return int(self.participation.shape[0])

    @property
    def num_clients(self) -> int:
        return int(self.participation.shape[1])

    def participate_at(self, r: int) -> np.ndarray:
        return self.participation[min(r, self.rounds - 1)]


def _window_events(kind: str, name: str, flags, args: dict) -> list:
    """Contiguous True runs of per-round ``flags`` → event window dicts."""
    out, start = [], None
    for r, f in enumerate(flags):
        if f and start is None:
            start = r
        elif not f and start is not None:
            out.append({"kind": kind, "name": name, "round": start,
                        "rounds": r - start, "args": args})
            start = None
    if start is not None:
        out.append({"kind": kind, "name": name, "round": start,
                    "rounds": len(flags) - start, "args": args})
    return out


def _realize_events(spec: Scenario) -> tuple:
    R = spec.rounds
    events: list = []
    for fl in spec.link_flaps:
        u, v = fl.link
        events += _window_events(
            "link_flap", f"flap {u}-{v}", [fl.is_down(r) for r in range(R)],
            {"link": [u, v], "period": fl.period})
    for cr in spec.crashes:
        events += _window_events(
            "crash", f"crash client {cr.node}",
            [cr.is_dead(r) for r in range(R)],
            {"node": cr.node, "recover": cr.recover})
    for i, sw in enumerate(spec.stragglers):
        events += _window_events(
            "stragglers", f"straggler window {i}",
            [sw.active(r) for r in range(R)],
            {"p_straggle": sw.p_straggle, "correlated": sw.correlated})
    for i, rp in enumerate(spec.ramps):
        events += _window_events(
            "bandwidth_ramp", f"bandwidth ramp {i}",
            [rp.factor(r) < 1.0 for r in range(R)],
            {"floor": rp.floor,
             "links": (None if rp.links is None
                       else [list(uv) for uv in rp.links])})
    for i, dl in enumerate(spec.deadlines):
        events += _window_events(
            "deadline", f"deadline {dl.deadline_s}s",
            [dl.active(r) for r in range(R)],
            {"deadline_s": dl.deadline_s, "mean_s": dl.mean_s})
    return tuple(sorted(events, key=lambda e: (e["round"], e["name"])))


def straggler_generator(seed: int, r: int) -> torch.Generator:
    """The straggler stream of a window with seed ``seed`` at round ``r``:
    a CPU generator seeded from both, the same on every compile."""
    return torch.Generator().manual_seed(int(seed) * 100003 + int(r))


def _participation(spec: Scenario) -> np.ndarray:
    """Realize all participation timelines into a [rounds, K] matrix."""
    R, K = spec.rounds, spec.num_clients
    part = np.ones((R, K), np.float32)
    for cr in spec.crashes:
        for r in range(R):
            if cr.is_dead(r):
                part[r, cr.node] = 0.0
    for sw in spec.stragglers:
        model = sw.model()
        prev = None
        for r in range(R):
            if not sw.active(r):
                prev = None      # correlation does not leap over a gap
                continue
            mask = model.sample(straggler_generator(sw.seed, r), K,
                                prev).numpy()
            prev = mask
            part[r] *= mask
    if spec.deadlines:
        from repro_torch.fed.topology import LatencyModel
        from repro_torch.runtime.fault import deadline_mask
        for dl in spec.deadlines:
            lm = LatencyModel(mean_s=dl.mean_s, sigma=dl.sigma, seed=dl.seed)
            for r in range(R):
                if dl.active(r):
                    times = torch.from_numpy(lm.sample(r, K))
                    part[r] *= deadline_mask(times, dl.deadline_s).numpy()
    return part


def compile_scenario(spec: Scenario, graph=None, *,
                     cfg=None) -> CompiledScenario:
    """Lower ``spec`` (+ optional pre-built base graph) — see module doc.

    ``graph`` overrides ``spec.topology.build()`` (it must have the spec's
    client count); ``cfg`` overrides ``spec.agg_config()`` for the
    bandwidth-aware budget base.
    """
    from repro_torch.agg.plan import bandwidth_budgets
    from repro_torch.agg.schedule import TopologySchedule

    R, K = spec.rounds, spec.num_clients
    if cfg is None:
        cfg = spec.agg_config()
    chain = spec.topology.kind in ("chain", "path")
    clustered = spec.topology.clusters is not None

    if spec.bandwidth_aware and (chain or clustered):
        raise ValueError("bandwidth_aware budgets need a flat routed graph "
                         "(chain has no link model; clustered budgets are "
                         "not supported)")
    if clustered and spec.topology.routing == "widest":
        raise ValueError("cluster routing supports latency/hops metrics, "
                         "not widest")

    # per-round fault configuration keys (dead sets / down links / factors)
    dead_at = [frozenset(cr.node for cr in spec.crashes if cr.is_dead(r))
               for r in range(R)]

    if chain:
        # the paper's chain: crashes splice (PR-era heal_chain semantics),
        # no link model — one healed tree per distinct dead set
        from repro_torch.topo.routing import healed_chain_tree
        keys = dead_at
        index_of: dict = {}
        topos, round_index = [], []
        for key in keys:
            if key not in index_of:
                index_of[key] = len(topos)
                topos.append(healed_chain_tree(K, sorted(key)))
            round_index.append(index_of[key])
        schedule = TopologySchedule.from_topologies(
            topos, num_clients=K, round_index=round_index, cyclic=False)
        return CompiledScenario(spec=spec, schedule=schedule,
                                participation=_participation(spec),
                                events=_realize_events(spec))

    if graph is None:
        graph = spec.topology.build()
    if graph.num_clients != K:
        raise ValueError(f"base graph has {graph.num_clients} clients, "
                         f"spec expects {K}")
    client_node = {i: int(v) for i, v in enumerate(graph.client_nodes())}

    fixed_clusters = None
    if clustered:
        # the partition is computed ONCE on the base graph and held fixed:
        # per-round exclusions re-route within it, so every round's nested
        # plan keeps the same per-stage unit counts (one padded signature)
        from repro_torch.topo.routing import partition_clusters
        fixed_clusters = partition_clusters(graph, spec.topology.clusters)

    down_at = [frozenset(fl.link for fl in spec.link_flaps
                         if fl.is_down(r)) for r in range(R)]
    factors_at = [tuple(rp.factor(r) for rp in spec.ramps)
                  for r in range(R)]

    def build_config(down, dead, factors):
        g = graph
        for rp, f in zip(spec.ramps, factors):
            if f < 1.0:
                g = g.with_bandwidth_scaled(f, rp.links)
        if down:
            g = g.without_links(down)
        exclude = tuple(sorted(client_node[i] for i in dead))
        if clustered:
            from repro_torch.topo.routing import cluster_routed
            topo = cluster_routed(g, clusters=fixed_clusters,
                                  metric=spec.topology.routing,
                                  exclude=exclude)
            return topo, None
        from repro_torch.topo.routing import route_tree
        tree = route_tree(g, spec.topology.routing, exclude=exclude)
        qb = bandwidth_budgets(cfg, tree) if spec.bandwidth_aware else None
        return tree, qb

    index_of = {}
    topos, budgets, round_index = [], [], []
    for r in range(R):
        key = (down_at[r], dead_at[r], factors_at[r])
        if key not in index_of:
            index_of[key] = len(topos)
            topo, qb = build_config(*key)
            topos.append(topo)
            budgets.append(qb)
        round_index.append(index_of[key])
    schedule = TopologySchedule.from_topologies(
        topos, num_clients=K, q_budgets=budgets, round_index=round_index,
        cyclic=False)
    return CompiledScenario(spec=spec, schedule=schedule,
                            participation=_participation(spec),
                            events=_realize_events(spec))
