"""The port's constellation graphs, routing, bandwidth budgets and topology
schedules against the JAX package's.

Every builder makes the same graph in both packages (edges, bandwidths,
latencies, client nodes), and every routing policy, with and without dead
relays, makes the same tree (parents, uplink bandwidths and latencies,
reachability) — the port keeps the reference's ``heapq`` Dijkstra, so ties
break alike. Cluster routing, ``bandwidth_budgets`` and the plans of
``TopologySchedule`` are compared the same way. No tolerance: all of it is
host numpy, compared exactly. The cases of ``tests/test_tree_topo.py``'s
graph and routing sections follow, on the port alone.
"""

import numpy as np
import pytest
import torch

from repro.agg import TopologySchedule as JSchedule
from repro.agg import bandwidth_budgets as jbudgets
from repro.agg import compile_plan as jcompile
from repro.core.algorithms import AggConfig as JCfg
from repro.fed.topology import TreeTopology as JTreeTopology
from repro.topo import graph as jg
from repro.topo import routing as jr
from repro_torch import convert
from repro_torch.agg import (TopologySchedule, bandwidth_budgets,
                             common_shape, compile_plan)
from repro_torch.core import comm_cost as cc
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.fed.topology import (ChainTopology, FailureSchedule,
                                      LatencyModel, TreeTopology)
from repro_torch.topo import graph as tg
from repro_torch.topo import routing as tr
from repro_torch.topo.tree import PS, AggTree, path_tree, round_latency_s

torch.set_num_threads(1)

BUILDERS = {
    "path-6": lambda m: m.path_graph(6),
    "star-6": lambda m: m.star_graph(6),
    "grid-2x3": lambda m: m.grid_graph(2, 3),
    "grid-3x4": lambda m: m.grid_graph(3, 4),
    "walker-delta-3x4": lambda m: m.walker_delta(3, 4, gateways=(1, 7)),
    "walker-delta-4x7": lambda m: m.walker_delta(4, 7, gateways=(1, 15)),
    "walker-star-4x3": lambda m: m.walker_star(4, 3),
    "geo-12": lambda m: m.random_geometric(12, seed=7),
    "geo-9-tight": lambda m: m.random_geometric(9, radius=0.05, seed=3),
}
POLICIES = ["latency", "hops", "widest"]


def _graph_fields(g):
    return (g.num_nodes, g.ps, np.asarray(g.edges),
            np.asarray(g.bandwidth_bps), np.asarray(g.latency_s),
            np.asarray(g.client_nodes()))


def _assert_graphs_equal(jgraph, tgraph):
    for a, b in zip(_graph_fields(jgraph), _graph_fields(tgraph)):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


def _tree_fields(t):
    return (t.parent, t.uplink_bw_bps, t.uplink_latency_s, t.reachable)


def _excludes(graph):
    nodes = [int(v) for v in graph.client_nodes()]
    return [(), (nodes[0],), (nodes[0], nodes[len(nodes) // 2])]


@pytest.mark.parametrize("name", BUILDERS)
def test_graph_builders_match_reference(name):
    jgraph, tgraph = BUILDERS[name](jg), BUILDERS[name](tg)
    _assert_graphs_equal(jgraph, tgraph)
    assert tgraph.is_connected() == jgraph.is_connected()
    links = [tuple(int(x) for x in tgraph.edges[i]) for i in (0, -1)]
    _assert_graphs_equal(jgraph.without_links(links),
                         tgraph.without_links(links))
    _assert_graphs_equal(jgraph.with_bandwidth_scaled(0.5, links[:1]),
                         tgraph.with_bandwidth_scaled(0.5, links[:1]))
    for ex in _excludes(tgraph):
        assert tgraph.adjacency(ex) == jgraph.adjacency(ex)
        assert tgraph.is_connected(ex) == jgraph.is_connected(ex)


@pytest.mark.parametrize("name", BUILDERS)
@pytest.mark.parametrize("policy", POLICIES)
def test_routing_matches_reference(name, policy):
    jgraph, tgraph = BUILDERS[name](jg), BUILDERS[name](tg)
    for ex in _excludes(tgraph):
        want = jr.route_tree(jgraph, policy, exclude=ex)
        got = tr.route_tree(tgraph, policy, exclude=ex)
        assert _tree_fields(got) == _tree_fields(want), ex
        # through TreeTopology, which takes dead *client* indices
        nodes = [int(v) for v in tgraph.client_nodes()]
        dead = tuple(nodes.index(v) for v in ex)
        jt = JTreeTopology(jgraph, routing=policy).tree(dead=dead)
        tt = TreeTopology(tgraph, routing=policy).tree(dead=dead)
        assert _tree_fields(tt) == _tree_fields(jt)
        np.testing.assert_array_equal(
            TreeTopology(tgraph, policy).alive_mask(tt, dead),
            np.asarray(JTreeTopology(jgraph, policy).alive_mask(jt, dead)))


@pytest.mark.parametrize("name", ["grid-3x4", "walker-delta-4x7",
                                  "walker-star-4x3", "geo-12"])
@pytest.mark.parametrize("metric", ["latency", "hops"])
def test_cluster_routing_matches_reference(name, metric):
    jgraph, tgraph = BUILDERS[name](jg), BUILDERS[name](tg)
    for ex in _excludes(tgraph)[:2]:
        for n in (1, 2, 3):
            assert (tr.partition_clusters(tgraph, n, exclude=ex)
                    == jr.partition_clusters(jgraph, n, exclude=ex))
        for n in (None, 3):
            want = jr.cluster_routed(jgraph, n, metric=metric, exclude=ex)
            got = tr.cluster_routed(tgraph, n, metric=metric, exclude=ex)
            assert got.clusters == want.clusters
            assert [_tree_fields(t) for t in got.intra] == \
                [_tree_fields(t) for t in want.intra]
            assert _tree_fields(got.inter) == _tree_fields(want.inter)
            assert (got.num_clients, got.num_clusters) == \
                (want.num_clients, want.num_clusters)
            ws, gs = want.nested_stages(), got.nested_stages()
            assert len(ws) == len(gs) == 2
            for wst, gst in zip(ws, gs):
                assert [m for m, _ in gst] == [m for m, _ in wst]
                assert [_tree_fields(t) for _, t in gst] == \
                    [_tree_fields(t) for _, t in wst]


def test_healed_chain_tree_matches_reference():
    for dead, order in [((), None), ((3,), None), ((0, 4), [2, 0, 5, 1, 4, 3])]:
        want = jr.healed_chain_tree(6, dead, order)
        got = tr.healed_chain_tree(6, dead, order)
        assert _tree_fields(got) == _tree_fields(want)


@pytest.mark.parametrize("name", ["walker-delta-3x4", "walker-delta-4x7",
                                  "geo-12", "grid-3x4"])
@pytest.mark.parametrize("kind", ["sia", "cl_sia", "tc_sia"])
def test_bandwidth_budgets_match_reference(name, kind):
    jgraph, tgraph = BUILDERS[name](jg), BUILDERS[name](tg)
    for floor in (1, 3):
        for ex in _excludes(tgraph):
            jt = jr.widest_path_tree(jgraph, exclude=ex)
            tt = tr.widest_path_tree(tgraph, exclude=ex)
            want = jbudgets(JCfg(kind=kind, q=23), jt, floor=floor)
            got = bandwidth_budgets(AggConfig(kind=kind, q=23), tt,
                                    floor=floor)
            np.testing.assert_array_equal(got, np.asarray(want))
            assert got.dtype == np.int32


def test_bandwidth_aware_plan_matches_reference():
    jgraph, tgraph = BUILDERS["walker-delta-4x7"](jg), \
        BUILDERS["walker-delta-4x7"](tg)
    want = JTreeTopology(jgraph, "widest").plan(
        dead=(0,), bandwidth_aware=True, cfg=JCfg(kind="cl_sia", q=78))
    got = TreeTopology(tgraph, "widest").plan(
        dead=(0,), bandwidth_aware=True, cfg=AggConfig(kind="cl_sia", q=78))
    _assert_plans_equal(convert.agg_plan(want), got)
    with pytest.raises(ValueError, match="cfg"):
        TreeTopology(tgraph).plan(bandwidth_aware=True)


def _assert_plans_equal(want, got):
    assert got.shape == want.shape
    for field in ("node_id", "slot_mask", "parent_row", "flat_pos", "alive",
                  "q_budget"):
        a, b = getattr(want, field), getattr(got, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=field)
    assert (got.num_clients, got.num_sinks) == \
        (want.num_clients, want.num_sinks)


# the time-varying example's timeline and the chip smoke's
EVENTS = {
    "example": (lambda m: m.walker_delta(3, 4, gateways=(1, 7)),
                {20: ([(1, 5), (1, 2)], []), 40: ([], [(1, 5), (1, 2)])},
                60),
    "card": (lambda m: m.walker_delta(4, 7, gateways=(1, 15)),
             {3: ([(1, 2), (1, 8)], []), 9: ([], [(1, 2), (1, 8)])}, 15),
    "partition": (lambda m: m.grid_graph(2, 3),
                  {1: ([(0, 1)], []), 3: ([(2, 3)], [(0, 1)])}, 5),
}


@pytest.mark.parametrize("case", EVENTS)
@pytest.mark.parametrize("routing", POLICIES)
def test_link_event_schedule_matches_reference(case, routing):
    build, events, rounds = EVENTS[case]
    want = JSchedule.from_link_events(build(jg), events, rounds=rounds,
                                      routing=routing)
    got = TopologySchedule.from_link_events(build(tg), events,
                                            rounds=rounds, routing=routing)
    assert got.shape == want.shape and len(got.plans) == len(want.plans)
    assert got.round_index == want.round_index
    assert len(got) == len(want) == rounds
    for r in range(rounds + 3):
        _assert_plans_equal(convert.agg_plan(want.plan_at(r)),
                            got.plan_at(r))
        assert _tree_fields(got.raw_at(r)) == _tree_fields(want.raw_at(r))


def test_schedule_from_topologies_matches_reference():
    k = 12
    tops = lambda m: [m.path_graph(k), m.star_graph(k), m.grid_graph(3, 4),
                      m.walker_delta(3, 4), m.random_geometric(k, seed=7)]
    want = JSchedule.from_topologies(tops(jg), round_index=[0, 1, 2, 3, 4, 2])
    got = TopologySchedule.from_topologies(tops(tg),
                                           round_index=[0, 1, 2, 3, 4, 2])
    assert got.shape == want.shape == common_shape(got.plans)
    assert got.round_index == want.round_index
    for r in range(8):
        _assert_plans_equal(convert.agg_plan(want.plan_at(r)),
                            got.plan_at(r))
    # q_budgets ride along; a chain order and an int K are topologies too
    qb = [np.arange(1, 7), None]
    with pytest.raises(ValueError, match="q_budget"):
        TopologySchedule.from_topologies([6, [5, 4, 3, 2, 1, 0]],
                                         q_budgets=qb)
    s = TopologySchedule.from_topologies([6, [5, 4, 3, 2, 1, 0]],
                                         cyclic=False)
    assert s.plan_at(7) is s.plans[1]


def test_schedule_guards():
    with pytest.raises(ValueError, match="share one"):
        TopologySchedule(plans=(compile_plan(3), compile_plan(5)),
                         round_index=(0, 1))
    with pytest.raises(ValueError, match="empty"):
        TopologySchedule(plans=(), round_index=())
    with pytest.raises(ValueError, match="round_index"):
        TopologySchedule(plans=(compile_plan(3),), round_index=(1,))
    with pytest.raises(ValueError, match="no plans"):
        common_shape([])
    nested = tr.cluster_routed(tg.grid_graph(3, 4), 2)
    with pytest.raises(NotImplementedError, match="A9"):
        TopologySchedule.from_topologies([nested])


def test_as_tree_branches_match_reference():
    """compile_plan of a graph, a TreeTopology, a ChainTopology and an
    order gives the reference's plan."""
    from repro.fed.topology import ChainTopology as JChain
    jgraph, tgraph = BUILDERS["grid-3x4"](jg), BUILDERS["grid-3x4"](tg)
    cases = [(jgraph, tgraph), (JTreeTopology(jgraph, "widest"),
                                TreeTopology(tgraph, "widest")),
             (JChain(12), ChainTopology(12)),
             (np.array([3, 1, 0, 2]), [3, 1, 0, 2])]
    for jt, tt in cases:
        _assert_plans_equal(convert.agg_plan(jcompile(jt)), compile_plan(tt))
    _assert_plans_equal(convert.agg_plan(JChain(5).plan(pad_to=(6, 2))),
                        ChainTopology(5).plan(pad_to=(6, 2)))
    np.testing.assert_array_equal(ChainTopology(5).healed_order([1, 3]),
                                  JChain(5).healed_order([1, 3]))


def test_failure_and_latency_models_match_reference():
    from repro.fed.topology import FailureSchedule as JFail
    from repro.fed.topology import LatencyModel as JLat
    events = {2: ([0, 3], []), 4: ([5], [0]), 7: ([], [3, 5])}
    for r in range(10):
        assert FailureSchedule(6, events).dead_at(r) == \
            JFail(6, events).dead_at(r)
    np.testing.assert_array_equal(LatencyModel(0.5, 0.3, 4).sample(3, 9),
                                  JLat(0.5, 0.3, 4).sample(3, 9))


# --- the cases of tests/test_tree_topo.py, on the port ----------------------

def test_walker_delta_is_torus():
    g = tg.walker_delta(3, 4)
    assert g.num_clients == 12 and g.is_connected()
    deg = np.zeros(g.num_nodes, int)
    for u, v in g.edges:
        deg[u] += 1
        deg[v] += 1
    assert all(deg[v] in (4, 5) for v in range(g.num_nodes) if v != g.ps)
    assert deg[g.ps] == 1


def test_walker_star_has_seam():
    delta, star = tg.walker_delta(3, 4), tg.walker_star(3, 4)
    assert star.edges.shape[0] == delta.edges.shape[0] - 4
    assert star.is_connected()


def test_shortest_path_tree_depths_are_graph_distances():
    g = tg.grid_graph(3, 3)
    depths = tr.shortest_path_tree(g, metric="hops").depths()
    for i, v in enumerate(g.client_nodes()):
        r, c = divmod(int(v) - 1, 3)
        assert depths[i] == r + c + 1


def test_widest_path_tree_maximizes_bottleneck():
    g = tg.ConstellationGraph(num_nodes=3,
                              edges=np.asarray([[0, 1], [0, 2], [1, 2]]),
                              bandwidth_bps=[1e6, 100e6, 100e6],
                              latency_s=[0.01, 0.01, 0.01], ps=0)
    tree = tr.widest_path_tree(g)
    assert tree.parent == (1, PS) and tree.uplink_bw_bps[0] == 100e6
    assert tr.shortest_path_tree(g, metric="hops").parent == (PS, PS)


def test_rerouting_gateway_loss_and_stubs():
    g = tg.grid_graph(2, 3)
    dead = int(g.client_nodes()[1])
    healed = tr.shortest_path_tree(g, exclude=[dead])
    assert not healed.reachable[1] and healed.parent[1] == PS
    assert all(healed.reachable[i] for i in range(6) if i != 1)
    assert healed.max_depth() >= tr.shortest_path_tree(g).max_depth()
    assert not any(tr.shortest_path_tree(
        g, exclude=[int(g.client_nodes()[0])]).reachable)
    line = tg.ConstellationGraph(num_nodes=3,
                                 edges=np.asarray([[0, 1], [1, 2]]),
                                 bandwidth_bps=1e6, latency_s=0.01, ps=0)
    stub = tr.shortest_path_tree(line, exclude=[1])
    assert stub.parent == (PS, PS) and stub.reachable == (False, False)
    with pytest.raises(ValueError, match="PS"):
        tr.shortest_path_tree(line, exclude=[0])
    with pytest.raises(ValueError, match="metric"):
        tr.shortest_path_tree(line, metric="nope")
    with pytest.raises(ValueError, match="routing"):
        tr.route_tree(line, "nope")


def test_graph_errors():
    with pytest.raises(ValueError, match="out of range"):
        tg.ConstellationGraph(num_nodes=2, edges=np.asarray([[0, 2]]),
                              bandwidth_bps=1.0, latency_s=1.0)
    with pytest.raises(ValueError, match="gateway"):
        tg.walker_delta(2, 3, gateways=(9,))
    with pytest.raises(ValueError, match="satellites"):
        tg.walker_star(2, 1)
    with pytest.raises(ValueError, match="positive"):
        tg.path_graph(3).with_bandwidth_scaled(0.0)
    with pytest.raises(ValueError, match="num_clusters"):
        tr.partition_clusters(tg.path_graph(3), 4)


def test_round_latency_depth_scaling():
    bits = [1e6] * 12
    chain = tr.shortest_path_tree(tg.path_graph(12, bandwidth_bps=50e6,
                                                latency_s=10e-3))
    star = tr.shortest_path_tree(tg.star_graph(12, bandwidth_bps=50e6,
                                               latency_s=10e-3))
    np.testing.assert_allclose(round_latency_s(chain, bits),
                               12 * round_latency_s(star, bits))


def test_bandwidth_budgets_reduce_bits_and_cap_nnz():
    """Narrow uplinks get smaller budgets, so the §V bits drop against the
    uniform budget and every hop's nnz stays within its budget."""
    from repro_torch.agg import execute
    tree = tr.widest_path_tree(tg.walker_delta(3, 4))
    k, d = tree.num_clients, 96
    cfg = AggConfig(kind=AggKind.CL_SIA, q=9)
    qb = bandwidth_budgets(cfg, tree)
    bw = np.asarray(tree.uplink_bw_bps)
    assert qb.max() == cfg.q and qb[bw < bw.max()].max() < cfg.q
    rng = np.random.default_rng(9)
    g = torch.from_numpy(rng.standard_normal((k, d), dtype=np.float32))
    e = torch.from_numpy(0.1 * rng.standard_normal((k, d), dtype=np.float32))
    w = torch.ones(k)
    uni = execute(cfg, compile_plan(tree), g, e, w)
    bwa = execute(cfg, compile_plan(tree, q_budget=qb), g, e, w)
    assert float(bwa.stats.bits.sum()) < float(uni.stats.bits.sum())
    assert (bwa.stats.nnz_out.numpy() <= qb).all()
    with pytest.raises(ValueError, match="bandwidth"):
        bandwidth_budgets(cfg, path_tree(3))
    stubs = AggTree(parent=(PS, PS), uplink_bw_bps=(0.0, 0.0))
    np.testing.assert_array_equal(bandwidth_budgets(cfg, stubs, floor=2),
                                  [2, 2])


def test_tree_closed_forms_on_routed_walker():
    tree = tr.widest_path_tree(tg.walker_delta(4, 7, gateways=(1, 15)))
    assert tree.num_clients == 28 and tree.max_depth() == 8
    assert cc.cl_sia_bits_tree(28, 7850, 78) == cc.cl_sia_bits(28, 7850, 78)
