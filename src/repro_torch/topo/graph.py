"""Constellation graph builders with per-link bandwidth/latency attributes
(port of :mod:`repro.topo.graph`).

A :class:`ConstellationGraph` is an undirected connected graph over nodes
``0..num_nodes-1`` where one node (``ps``) is the parameter server (a ground
station or gateway). All other nodes are FL clients. Edges model
inter-satellite links (ISLs) or ground links and carry ``bandwidth_bps`` and
``latency_s`` attributes used by the routing layer to pick aggregation trees.

Builders are deterministic (seeded where stochastic) and host-side numpy;
the same calls in the same order as the reference, so a seed builds the
same graph in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

# Default link classes, loosely after LEO ISL literature (arXiv:2307.08346):
# intra-plane ISLs are stable & wide; inter-plane ISLs are narrower; the
# ground (PS) link is the scarcest.
INTRA_PLANE_BW = 200e6    # bits/s
INTER_PLANE_BW = 100e6
GROUND_BW = 50e6
ISL_LATENCY = 10e-3       # s, one hop
GROUND_LATENCY = 30e-3


@dataclasses.dataclass(frozen=True)
class ConstellationGraph:
    """Undirected graph with link attributes; node ``ps`` is the server.

    ``edges`` is [E, 2] int (u < v canonical order); ``bandwidth_bps`` and
    ``latency_s`` are [E] floats aligned with ``edges``.
    """

    num_nodes: int
    edges: np.ndarray
    bandwidth_bps: np.ndarray
    latency_s: np.ndarray
    ps: int = 0

    def __post_init__(self):
        e = np.asarray(self.edges, np.int64).reshape(-1, 2)
        e = np.sort(e, axis=1)
        object.__setattr__(self, "edges", e)
        object.__setattr__(
            self, "bandwidth_bps",
            np.broadcast_to(np.asarray(self.bandwidth_bps, np.float64),
                            (e.shape[0],)).copy())
        object.__setattr__(
            self, "latency_s",
            np.broadcast_to(np.asarray(self.latency_s, np.float64),
                            (e.shape[0],)).copy())
        if e.size and (e.min() < 0 or e.max() >= self.num_nodes):
            raise ValueError("edge endpoint out of range")
        if not 0 <= self.ps < self.num_nodes:
            raise ValueError(f"ps={self.ps} out of range")

    @property
    def num_clients(self) -> int:
        return self.num_nodes - 1

    def client_nodes(self) -> np.ndarray:
        """Graph node ids of the clients, in client-index order.

        Client ``i`` (the row index of the simulator's [K, d] arrays) is the
        i-th non-PS node in ascending node-id order.
        """
        return np.asarray([v for v in range(self.num_nodes) if v != self.ps],
                          np.int64)

    def adjacency(self, exclude: Iterable[int] = ()) -> list:
        """Adjacency list: ``adj[u] = [(v, edge_idx), ...]``.

        ``exclude`` drops nodes (dead relays) and their incident links.
        """
        dead = set(exclude)
        adj: list = [[] for _ in range(self.num_nodes)]
        for idx, (u, v) in enumerate(self.edges):
            u, v = int(u), int(v)
            if u in dead or v in dead:
                continue
            adj[u].append((v, idx))
            adj[v].append((u, idx))
        return adj

    def without_links(self, links: Iterable[tuple]) -> "ConstellationGraph":
        """Copy of the graph with the given ``(u, v)`` links removed.

        Link endpoints are canonicalized (order-insensitive); unknown links
        are ignored. This is the LEO link-outage primitive: a handover or
        occlusion drops an ISL while both satellites stay up (contrast
        ``adjacency(exclude=...)``, which drops whole nodes).
        """
        down = {(min(int(u), int(v)), max(int(u), int(v))) for u, v in links}
        keep = [i for i, (u, v) in enumerate(self.edges)
                if (int(u), int(v)) not in down]
        return ConstellationGraph(num_nodes=self.num_nodes,
                                  edges=self.edges[keep],
                                  bandwidth_bps=self.bandwidth_bps[keep],
                                  latency_s=self.latency_s[keep],
                                  ps=self.ps)

    def with_bandwidth_scaled(self, factor: float,
                              links: Iterable[tuple] = None
                              ) -> "ConstellationGraph":
        """Copy with link bandwidths multiplied by ``factor``.

        ``links`` restricts the scaling to the given ``(u, v)`` pairs
        (canonicalized; unknown pairs ignored); None scales every link.
        This is the bandwidth-degradation primitive: rain fade or a
        contended gateway shrinks capacity while the link stays up, so
        routing (widest-path) and bandwidth-aware Top-Q budgets shift.
        """
        if factor <= 0:
            raise ValueError("bandwidth factor must be positive")
        bw = self.bandwidth_bps.copy()
        if links is None:
            bw *= factor
        else:
            sel = {(min(int(u), int(v)), max(int(u), int(v)))
                   for u, v in links}
            for i, (u, v) in enumerate(self.edges):
                if (int(u), int(v)) in sel:
                    bw[i] *= factor
        return ConstellationGraph(num_nodes=self.num_nodes, edges=self.edges,
                                  bandwidth_bps=bw, latency_s=self.latency_s,
                                  ps=self.ps)

    def is_connected(self, exclude: Iterable[int] = ()) -> bool:
        dead = set(exclude)
        alive = [v for v in range(self.num_nodes) if v not in dead]
        if not alive:
            return True
        adj = self.adjacency(exclude)
        seen = {alive[0]}
        stack = [alive[0]]
        while stack:
            u = stack.pop()
            for v, _ in adj[u]:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        return len(seen) == len(alive)


def _build(num_nodes: int, edge_list: Sequence[tuple], ps: int
           ) -> ConstellationGraph:
    """edge_list entries: (u, v, bandwidth, latency). De-dups parallel edges
    (keeps the best bandwidth)."""
    best: dict = {}
    for u, v, bw, lat in edge_list:
        key = (min(u, v), max(u, v))
        if key not in best or bw > best[key][0]:
            best[key] = (bw, lat)
    keys = sorted(best)
    edges = np.asarray(keys, np.int64).reshape(-1, 2)
    bw = np.asarray([best[k][0] for k in keys], np.float64)
    lat = np.asarray([best[k][1] for k in keys], np.float64)
    return ConstellationGraph(num_nodes=num_nodes, edges=edges,
                              bandwidth_bps=bw, latency_s=lat, ps=ps)


# ---------------------------------------------------------------------------
# Elementary topologies (tests / baselines)
# ---------------------------------------------------------------------------

def path_graph(num_clients: int, *, bandwidth_bps: float = INTRA_PLANE_BW,
               latency_s: float = ISL_LATENCY) -> ConstellationGraph:
    """PS — c0 — c1 — … — c(K−1): the paper's K-hop chain as a graph.

    Node 0 is the PS; node ``i+1`` is client ``i`` (paper client k = i+1,
    matching ``run_chain``'s row indexing).
    """
    k = num_clients
    edges = [(i, i + 1, bandwidth_bps, latency_s) for i in range(k)]
    return _build(k + 1, edges, ps=0)


def star_graph(num_clients: int, *, bandwidth_bps: float = GROUND_BW,
               latency_s: float = GROUND_LATENCY) -> ConstellationGraph:
    """Every client directly linked to the PS (classic FedAvg topology)."""
    k = num_clients
    edges = [(0, i + 1, bandwidth_bps, latency_s) for i in range(k)]
    return _build(k + 1, edges, ps=0)


def grid_graph(rows: int, cols: int, *,
               bandwidth_bps: float = INTER_PLANE_BW,
               latency_s: float = ISL_LATENCY,
               ground_bw: float = GROUND_BW,
               ground_latency: float = GROUND_LATENCY) -> ConstellationGraph:
    """rows×cols ISL mesh; PS (node 0) uplinks to the (0, 0) corner sat.

    Satellite (r, c) is node ``1 + r*cols + c``.
    """
    def nid(r, c):
        return 1 + r * cols + c

    edges = [(0, nid(0, 0), ground_bw, ground_latency)]
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                edges.append((nid(r, c), nid(r, c + 1),
                              bandwidth_bps, latency_s))
            if r + 1 < rows:
                edges.append((nid(r, c), nid(r + 1, c),
                              bandwidth_bps, latency_s))
    return _build(1 + rows * cols, edges, ps=0)


# ---------------------------------------------------------------------------
# Walker constellations
# ---------------------------------------------------------------------------

def _walker(num_planes: int, sats_per_plane: int, *, close_seam: bool,
            intra_bw: float, inter_bw: float, ground_bw: float,
            gateways: Sequence[int]) -> ConstellationGraph:
    """Shared Walker builder. Node 0 = PS (ground station); satellite j of
    plane p is node ``1 + p*sats_per_plane + j``. Intra-plane ISLs form a
    ring within each plane; inter-plane ISLs connect same-slot satellites of
    adjacent planes (wrapping plane P−1 → 0 only when ``close_seam``)."""
    P, S = num_planes, sats_per_plane
    if P < 1 or S < 2:
        raise ValueError("need ≥1 plane of ≥2 satellites")

    def nid(p, j):
        return 1 + p * S + j

    edges = []
    for p in range(P):
        for j in range(S):
            edges.append((nid(p, j), nid(p, (j + 1) % S),
                          intra_bw, ISL_LATENCY))
    pmax = P if close_seam else P - 1
    for p in range(pmax):
        for j in range(S):
            edges.append((nid(p, j), nid((p + 1) % P, j),
                          inter_bw, ISL_LATENCY))
    for g in gateways:
        if not 1 <= g <= P * S:
            raise ValueError(f"gateway node {g} out of range")
        edges.append((0, g, ground_bw, GROUND_LATENCY))
    return _build(1 + P * S, edges, ps=0)


def walker_delta(num_planes: int, sats_per_plane: int, *,
                 intra_bw: float = INTRA_PLANE_BW,
                 inter_bw: float = INTER_PLANE_BW,
                 ground_bw: float = GROUND_BW,
                 gateways: Sequence[int] = (1,)) -> ConstellationGraph:
    """Walker-delta (e.g. Starlink-like): inter-plane links wrap around —
    the plane graph itself is a ring, so the ISL mesh is a torus."""
    return _walker(num_planes, sats_per_plane, close_seam=True,
                   intra_bw=intra_bw, inter_bw=inter_bw, ground_bw=ground_bw,
                   gateways=gateways)


def walker_star(num_planes: int, sats_per_plane: int, *,
                intra_bw: float = INTRA_PLANE_BW,
                inter_bw: float = INTER_PLANE_BW,
                ground_bw: float = GROUND_BW,
                gateways: Sequence[int] = (1,)) -> ConstellationGraph:
    """Walker-star (e.g. Iridium-like): polar planes spanning ~180° — no
    inter-plane ISLs across the counter-rotating seam."""
    return _walker(num_planes, sats_per_plane, close_seam=False,
                   intra_bw=intra_bw, inter_bw=inter_bw, ground_bw=ground_bw,
                   gateways=gateways)


# ---------------------------------------------------------------------------
# Random geometric graphs (ad-hoc / aerial scenarios)
# ---------------------------------------------------------------------------

def random_geometric(num_clients: int, radius: float = 0.35, *,
                     seed: int = 0, bandwidth_bps: float = INTER_PLANE_BW,
                     latency_s: float = ISL_LATENCY) -> ConstellationGraph:
    """Random geometric graph on the unit square; PS at the node nearest the
    centroid. Link bandwidth decays with squared distance (free-space-loss
    flavored); the radius is grown until the graph is connected so the
    builder always returns a usable topology.
    """
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(num_clients + 1, 2))
    ps = int(np.argmin(np.linalg.norm(pts - pts.mean(0), axis=1)))

    r = radius
    for _ in range(32):
        edges = []
        for u in range(num_clients + 1):
            for v in range(u + 1, num_clients + 1):
                dist = float(np.linalg.norm(pts[u] - pts[v]))
                if dist <= r:
                    bw = bandwidth_bps / (1.0 + (dist / max(r, 1e-9)) ** 2)
                    edges.append((u, v, bw, latency_s * (0.5 + dist)))
        g = _build(num_clients + 1, edges, ps=ps) if edges else None
        if g is not None and g.is_connected():
            return g
        r *= 1.3
    raise RuntimeError("could not build a connected geometric graph")
