"""Spanning-tree extraction: graph + PS → aggregation tree (port of
:mod:`repro.topo.routing`).

Incremental aggregation needs each client to forward exactly one partial
aggregate toward the PS, i.e. a spanning tree of the (surviving) constellation
graph rooted at the PS. Two extraction policies:

* :func:`shortest_path_tree` — Dijkstra from the PS under a ``latency`` or
  ``hops`` metric. Minimizes per-round aggregation latency (tree depth).
* :func:`widest_path_tree` — maximize the *bottleneck bandwidth* of every
  client's path to the PS (max-min Dijkstra). With CL-SIA's constant
  per-hop payload, round time is dominated by the narrowest link on the
  deepest path, which this policy widens.

Both return a parent map over *graph node ids*; :func:`extract_tree`
relabels into client index space (:class:`repro_torch.topo.tree.AggTree`),
attaching per-client uplink bandwidth/latency for the cost model. Dead
relays (``exclude``) are routed around; if removal disconnects the graph,
the stranded clients are parked at depth 1 with zero bandwidth so the
simulator can mark them non-participating while keeping array shapes static.

**Cluster-aware routing** (:func:`cluster_routed`) is the staged variant:
partition the clients into pods/clusters (:func:`partition_clusters`,
farthest-point seeded multi-source BFS), route an intra-cluster tree to
each cluster's relay head, and route a relay tree over the heads — the
:class:`NestedTopology` a staged plan is compiled from (satellite
deployments: aggregate inside each orbital plane/cluster over wide ISLs,
then relay per-cluster partials over the scarce inter-cluster/ground
links).

Dijkstra runs on ``heapq`` exactly as the reference writes it, so ties
break in the same discovery order and the trees are the reference's.
"""

from __future__ import annotations

import heapq
import math
from typing import Iterable, NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.topo.graph import ConstellationGraph
from repro_torch.topo.tree import PS, AggTree


def _dijkstra(graph: ConstellationGraph, cost_of_edge, combine,
              exclude: Iterable[int],
              start_cost: float = 0.0) -> tuple[dict, dict]:
    """Generic best-path tree from the PS.

    ``cost_of_edge(idx) -> float`` and ``combine(path_cost, edge_cost)``
    define the metric; smaller is better. ``start_cost`` is the PS's own
    path cost — the identity of ``combine`` (0 for sums, −inf for max-min).
    Returns ({node: parent_node}, {node: edge_idx to parent}) for every
    reachable non-excluded node.
    """
    dead = set(exclude)
    if graph.ps in dead:
        raise ValueError("cannot exclude the PS node")
    adj = graph.adjacency(exclude=dead)
    dist = {graph.ps: start_cost}
    parent: dict = {}
    via_edge: dict = {}
    heap = [(start_cost, graph.ps)]
    while heap:
        du, u = heapq.heappop(heap)
        if du > dist.get(u, math.inf):
            continue
        for v, idx in adj[u]:
            dv = combine(du, cost_of_edge(idx))
            if dv < dist.get(v, math.inf):
                dist[v] = dv
                parent[v] = u
                via_edge[v] = idx
                heapq.heappush(heap, (dv, v))
    return parent, via_edge


def shortest_path_tree(graph: ConstellationGraph, *, metric: str = "latency",
                       exclude: Iterable[int] = ()) -> AggTree:
    """Dijkstra tree from the PS. ``metric``: "latency" (Σ link latency)
    or "hops" (unweighted BFS)."""
    if metric == "latency":
        cost = lambda idx: float(graph.latency_s[idx])
    elif metric == "hops":
        cost = lambda idx: 1.0
    else:
        raise ValueError(f"unknown metric {metric!r}")
    parent, via = _dijkstra(graph, cost, lambda a, b: a + b, exclude)
    return extract_tree(graph, parent, via)


def widest_path_tree(graph: ConstellationGraph,
                     exclude: Iterable[int] = ()) -> AggTree:
    """Max-bottleneck-bandwidth tree (widest-path Dijkstra).

    Path cost = −min(link bandwidth along path); ties broken by discovery
    order. Every client gets the maximum achievable bottleneck bandwidth to
    the PS among all its paths.
    """
    parent, via = _dijkstra(
        graph,
        lambda idx: -float(graph.bandwidth_bps[idx]),
        lambda path_cost, edge_cost: max(path_cost, edge_cost),
        exclude, start_cost=-math.inf)
    return extract_tree(graph, parent, via)


def route_tree(graph: ConstellationGraph, routing: str = "latency",
               exclude: Iterable[int] = ()) -> AggTree:
    """Route by policy name: ``latency``/``hops`` (shortest-path) or
    ``widest`` (max-bottleneck-bandwidth). The string dispatch the schedule
    and scenario compilers share."""
    if routing == "widest":
        return widest_path_tree(graph, exclude=exclude)
    if routing in ("latency", "hops"):
        return shortest_path_tree(graph, metric=routing, exclude=exclude)
    raise ValueError(f"unknown routing {routing!r}")


def healed_chain_tree(num_clients: int, dead: Iterable[int] = (),
                      order: Optional[Sequence] = None) -> AggTree:
    """The paper's chain with dead clients spliced out, as an
    :class:`AggTree`.

    ``order`` lists client indices PS-outward (default 0..K−1); ``dead``
    clients are removed via :func:`repro_torch.runtime.fault.heal_chain` and the
    survivors chained in healed order (``order[0]`` adjacent to the PS).
    The dead clients stay in the tree as unreachable stubs (parent = PS,
    ``reachable`` False) so the [K]-shaped arrays keep their rows — the
    plan's ``alive`` mask zeros them. This keeps multi-node crash healing
    inside ``compile_plan``'s full-permutation contract.
    """
    from repro_torch.runtime.fault import heal_chain
    if order is None:
        order = np.arange(num_clients, dtype=np.int32)
    healed = heal_chain(np.asarray(order, np.int32), tuple(dead))
    parent = np.full((num_clients,), PS, np.int64)
    reach = np.zeros((num_clients,), bool)
    prev = PS
    for o in healed:
        parent[int(o)] = prev
        reach[int(o)] = True
        prev = int(o)
    return AggTree(parent=tuple(int(p) for p in parent),
                   reachable=tuple(bool(r) for r in reach))


def extract_tree(graph: ConstellationGraph, parent_of_node: dict,
                 via_edge: Optional[dict] = None) -> AggTree:
    """Relabel a {node: parent_node} map into client index space.

    Clients are the non-PS nodes of the *full* graph in ascending node-id
    order (stable across failures, matching the simulator's [K, d] rows).
    Unreachable clients (dead or disconnected) become depth-1 stubs with
    parent = PS and zero uplink bandwidth; callers must zero their
    ``participate`` mask.
    """
    nodes = graph.client_nodes()
    index_of = {int(v): i for i, v in enumerate(nodes)}
    k = len(nodes)
    parent = np.full((k,), PS, np.int64)
    bw = np.zeros((k,), np.float64)
    lat = np.zeros((k,), np.float64)
    reachable = np.zeros((k,), bool)
    for i, v in enumerate(nodes):
        v = int(v)
        if v in parent_of_node:
            p = int(parent_of_node[v])
            parent[i] = PS if p == graph.ps else index_of[p]
            reachable[i] = True
            if via_edge is not None and v in via_edge:
                idx = via_edge[v]
                bw[i] = float(graph.bandwidth_bps[idx])
                lat[i] = float(graph.latency_s[idx])
        else:
            parent[i] = PS       # stranded stub; participate must be 0
    return AggTree(parent=tuple(int(p) for p in parent),
                   uplink_bw_bps=tuple(float(b) for b in bw),
                   uplink_latency_s=tuple(float(l) for l in lat),
                   reachable=tuple(bool(r) for r in reachable))


# ---------------------------------------------------------------------------
# Cluster-aware routing (pods/clusters → staged NestedTopology)
# ---------------------------------------------------------------------------

class NestedTopology(NamedTuple):
    """Staged aggregation route: clusters + intra trees + inter relay tree.

    ``clusters[c]`` are the global client indices of cluster c (together a
    partition of 0..K−1); ``intra[c]`` is an :class:`AggTree` over cluster
    c's members in listed order, rooted at the cluster's relay head (local
    ``PS``); ``inter`` is an :class:`AggTree` over the C cluster units.
    :meth:`nested_stages` gives the two-stage spec a nested plan compiler
    consumes.
    """

    clusters: tuple           # tuple[tuple[int, ...], ...]
    intra: tuple              # tuple[AggTree, ...] (local index space)
    inter: AggTree            # tree over the C cluster units

    @property
    def num_clients(self) -> int:
        return sum(len(c) for c in self.clusters)

    @property
    def num_clusters(self) -> int:
        return len(self.clusters)

    def nested_stages(self) -> list:
        """The two-stage spec ``compile_nested`` consumes."""
        return [list(zip(self.clusters, self.intra)),
                [(tuple(range(len(self.clusters))), self.inter)]]


def _hop_dists(adj: list, start: int, num_nodes: int) -> np.ndarray:
    dist = np.full((num_nodes,), np.inf)
    dist[start] = 0.0
    frontier = [start]
    while frontier:
        nxt = []
        for u in frontier:
            for v, _ in adj[u]:
                if not np.isfinite(dist[v]):
                    dist[v] = dist[u] + 1
                    nxt.append(v)
        frontier = nxt
    return dist


def partition_clusters(graph: ConstellationGraph, num_clusters: int, *,
                       exclude: Iterable[int] = ()) -> list:
    """Partition the clients into ``num_clusters`` connected-ish clusters.

    Farthest-point seeding (hop metric) followed by balanced multi-source
    BFS growth: seeds claim unassigned neighbors one ring at a time,
    smallest cluster first, so cluster sizes stay within one BFS ring of
    each other on regular graphs. Unreachable clients are appended to
    cluster 0 (they become stubs downstream). Returns a list of sorted
    client-index lists.
    """
    nodes = [int(v) for v in graph.client_nodes()]
    index_of = {v: i for i, v in enumerate(nodes)}
    dead = set(int(v) for v in exclude)
    adj = graph.adjacency(exclude=dead)
    k = len(nodes)
    if not 1 <= num_clusters <= k:
        raise ValueError(f"num_clusters must be in 1..{k}")

    # farthest-point seeds, starting from the client farthest from the PS
    d_ps = _hop_dists(adj, graph.ps, graph.num_nodes)
    alive = [v for v in nodes if v not in dead and np.isfinite(d_ps[v])]
    if not alive:
        return [sorted(index_of[v] for v in nodes)] + \
            [[] for _ in range(num_clusters - 1)]
    seeds = [max(alive, key=lambda v: d_ps[v])]
    min_d = _hop_dists(adj, seeds[0], graph.num_nodes)
    while len(seeds) < num_clusters:
        cand = max(alive, key=lambda v: min_d[v])
        seeds.append(cand)
        min_d = np.minimum(min_d, _hop_dists(adj, cand, graph.num_nodes))

    owner = {v: c for c, v in enumerate(seeds)}
    frontiers = [[v] for v in seeds]
    remaining = set(alive) - set(seeds)
    while remaining and any(frontiers):
        # smallest cluster grows first — balance
        order = np.argsort([sum(1 for v in owner if owner[v] == c)
                            for c in range(num_clusters)])
        progress = False
        for c in order:
            nxt = []
            for u in frontiers[c]:
                for v, _ in adj[u]:
                    if v in remaining:
                        owner[v] = c
                        remaining.discard(v)
                        nxt.append(v)
                        progress = True
            frontiers[c] = nxt
        if not progress:
            break
    clusters = [[] for _ in range(num_clusters)]
    for v, c in owner.items():
        clusters[c].append(index_of[v])
    for v in nodes:        # dead / disconnected → cluster 0 stubs
        if v not in owner:
            clusters[0].append(index_of[v])
    return [sorted(c) for c in clusters]


def _subgraph_tree(graph: ConstellationGraph, members_nodes: list,
                   head: int, metric: str,
                   exclude: Iterable[int] = ()) -> AggTree:
    """Route a tree over ``members_nodes`` (graph ids) inside their induced
    subgraph, rooted at ``head``. Local client order = listed order. Dead
    nodes (``exclude``) are never relayed through — they end up as local
    stubs (``reachable`` False)."""
    dead = set(exclude)
    allowed = set(members_nodes) - dead
    local = {v: i for i, v in enumerate(members_nodes)}
    cost = ((lambda idx: float(graph.latency_s[idx])) if metric == "latency"
            else (lambda idx: 1.0))
    adj = graph.adjacency(exclude=dead)
    dist = {head: 0.0}
    parent: dict = {}
    via: dict = {}
    heap = [(0.0, head)]
    while heap:
        du, u = heapq.heappop(heap)
        if du > dist.get(u, math.inf):
            continue
        for v, idx in adj[u]:
            if v not in allowed:
                continue
            dv = du + cost(idx)
            if dv < dist.get(v, math.inf):
                dist[v] = dv
                parent[v] = u
                via[v] = idx
                heapq.heappush(heap, (dv, v))
    m = len(members_nodes)
    par = np.full((m,), PS, np.int64)
    bw = np.zeros((m,))
    lat = np.zeros((m,))
    reach = np.zeros((m,), bool)
    for v in members_nodes:
        i = local[v]
        if v == head:
            reach[i] = v not in dead
        elif v in parent:
            par[i] = local[parent[v]]
            reach[i] = True
            bw[i] = float(graph.bandwidth_bps[via[v]])
            lat[i] = float(graph.latency_s[via[v]])
    return AggTree(parent=tuple(int(p) for p in par),
                   uplink_bw_bps=tuple(float(b) for b in bw),
                   uplink_latency_s=tuple(float(l) for l in lat),
                   reachable=tuple(bool(r) for r in reach))


def cluster_routed(graph: ConstellationGraph, num_clusters: Optional[int]
                   = None, *, metric: str = "latency",
                   clusters: Optional[Sequence] = None,
                   exclude: Iterable[int] = ()) -> NestedTopology:
    """Cluster-aware route: pods/clusters → intra trees + inter relay tree.

    Partitions the constellation into ``num_clusters`` clusters (default
    ≈√K; or pass explicit ``clusters`` of client indices), picks each
    cluster's *relay head* (the member nearest the PS under ``metric``),
    routes an intra-cluster tree to the head inside the cluster's induced
    subgraph, and routes the relay tree over the heads in the quotient
    graph (best inter-cluster link per cluster pair; the PS keeps its
    ground links). Members a cluster's subgraph cannot reach become local
    stubs; clusters the quotient cannot reach become stub units — both are
    zeroed via the plans' ``alive`` masks downstream.
    """
    nodes = [int(v) for v in graph.client_nodes()]
    k = len(nodes)
    if clusters is None:
        if num_clusters is None:
            num_clusters = max(1, int(round(math.sqrt(k))))
        clusters = partition_clusters(graph, num_clusters, exclude=exclude)
    clusters = [list(c) for c in clusters if len(c)]
    c_of = {}
    for c, mem in enumerate(clusters):
        for i in mem:
            c_of[int(i)] = c

    # relay heads: nearest-to-PS member under the full-graph metric
    # (dead relays excluded — a head must be a live node)
    dead = set(int(v) for v in exclude)
    cost = ((lambda idx: float(graph.latency_s[idx])) if metric == "latency"
            else (lambda idx: 1.0))
    parent_ps, via_ps = _dijkstra(graph, cost, lambda a, b: a + b, dead)
    dist_ps = {}
    for v in nodes:
        d, node, ok = 0.0, v, v in parent_ps
        while ok and node != graph.ps:
            d += cost(via_ps[node])
            node = parent_ps[node]
        dist_ps[v] = d if ok else math.inf
    heads = []
    for mem in clusters:
        mem_nodes = [nodes[i] for i in mem]
        heads.append(min(mem_nodes, key=lambda v: dist_ps[v]))

    intra = tuple(_subgraph_tree(graph, [nodes[i] for i in mem], head,
                                 metric, exclude=dead)
                  for mem, head in zip(clusters, heads))

    # quotient graph over cluster units (+ PS): best link per pair
    c_of_node = {nodes[i]: c for i, c in
                 ((i, c_of[i]) for mem in clusters for i in mem)}
    best: dict = {}
    for idx, (u, v) in enumerate(graph.edges):
        u, v = int(u), int(v)
        if u in dead or v in dead:
            continue
        cu = -1 if u == graph.ps else c_of_node.get(u)
        cv = -1 if v == graph.ps else c_of_node.get(v)
        if cu is None or cv is None or cu == cv:
            continue
        key = (min(cu, cv), max(cu, cv))
        w = cost(idx)
        if key not in best or w < best[key][0]:
            best[key] = (w, idx)
    c = len(clusters)
    par = np.full((c,), PS, np.int64)
    bw = np.zeros((c,))
    lat = np.zeros((c,))
    reach = np.zeros((c,), bool)
    dist = {-1: 0.0}
    heap = [(0.0, -1)]
    qadj: dict = {}
    for (a, b), (w, idx) in best.items():
        qadj.setdefault(a, []).append((b, w, idx))
        qadj.setdefault(b, []).append((a, w, idx))
    qparent: dict = {}
    qvia: dict = {}
    while heap:
        du, u = heapq.heappop(heap)
        if du > dist.get(u, math.inf):
            continue
        for v, w, idx in qadj.get(u, []):
            dv = du + w
            if dv < dist.get(v, math.inf):
                dist[v] = dv
                qparent[v] = u
                qvia[v] = idx
                heapq.heappush(heap, (dv, v))
    for ci in range(c):
        if ci in qparent:
            p = qparent[ci]
            par[ci] = PS if p == -1 else p
            reach[ci] = True
            bw[ci] = float(graph.bandwidth_bps[qvia[ci]])
            lat[ci] = float(graph.latency_s[qvia[ci]])
    inter = AggTree(parent=tuple(int(p) for p in par),
                    uplink_bw_bps=tuple(float(b) for b in bw),
                    uplink_latency_s=tuple(float(l) for l in lat),
                    reachable=tuple(bool(r) for r in reach))
    return NestedTopology(clusters=tuple(tuple(int(i) for i in mem)
                                         for mem in clusters),
                          intra=intra, inter=inter)
