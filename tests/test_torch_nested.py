"""The port's nested (staged) aggregation plans against the JAX package's.

Every case of ``tests/test_nested_plan.py`` on the port, and beside it the
reference on the same numpy inputs:

* ``compile_nested`` / ``pod_ring_nested`` / routed ``NestedTopology``s
  give the reference's plan leaves, shapes and ``client_alive``;
* ``execute_nested`` equals the jitted reference bit for bit (aggregate,
  client EF, every stage EF tier, every stage's counts and bits) for the
  five algorithms under exact Top-Q and threshold Top-Q (scan and hist),
  with stragglers; ``err_sq`` (a row sum in XLA's order) to rtol 1e-6;
* the staged closed forms equal the reference's, and the measured bits
  equal them;
* a schedule of nested plans pads to the reference's signature;
* one nested simulator round fed the reference's state and gradients is
  bitwise, and five rounds replaying the reference's minibatch draws agree
  to rtol 1e-4 in the loss.

The reference's single-specialization case becomes "one input signature
for same-shape nested plans" on the simulator's ``TraceCounter``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.agg import nested as jn
from repro.agg import TopologySchedule as JSchedule
from repro.configs import PAPER as JPAPER
from repro.core import comm_cost as jcc
from repro.core import tcs as jtcs
from repro.core.algorithms import AggConfig as JCfg
from repro.core.hierarchical import dci_bytes_flat_vs_hier
from repro.data.federated import client_minibatch as jminibatch
from repro.data.federated import partition_iid as jpartition
from repro.data.synthetic import make_synthetic_mnist as jmnist
from repro.fed import simulator as jsim
from repro.topo import graph as jg
from repro.topo import routing as jr
from repro.topo.tree import AggTree as JAggTree
from repro_torch import convert
from repro_torch.agg import TopologySchedule
from repro_torch.agg import nested as tn
from repro_torch.agg.nested import (NestedPlan, compile_nested,
                                    execute_nested, pod_ring_nested,
                                    zero_stage_ef)
from repro_torch.configs import PAPER
from repro_torch.core import comm_cost as cc
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.fed import Simulator
from repro_torch.fed.topology import TreeTopology
from repro_torch.topo import graph as tg
from repro_torch.topo import routing as tr
from repro_torch.topo.routing import cluster_routed, partition_clusters
from repro_torch.topo.tree import PS, AggTree

torch.set_num_threads(1)

ALL_SPARSE = [AggKind.SIA, AggKind.RE_SIA, AggKind.CL_SIA, AggKind.TC_SIA,
              AggKind.CL_TC_SIA]
KINDS = [k.value for k in ALL_SPARSE]
IMPLS = {"exact": {},
         "scan": dict(topq_impl="threshold", tau_impl="scan",
                      hist_rounds=3),
         "hist": dict(topq_impl="threshold", tau_impl="hist",
                      hist_rounds=2)}
ERR_RTOL = 1e-6
LOSS_RTOL = 1e-4


def _inputs(k, d, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((k, d), dtype=np.float32)
    e = rng.standard_normal((k, d), dtype=np.float32) * np.float32(0.1)
    return (torch.from_numpy(g), torch.from_numpy(e),
            torch.ones((k,), dtype=torch.float32))


def _gmask(cfg, d):
    if cfg.kind in (AggKind.TC_SIA, AggKind.CL_TC_SIA):
        m = torch.zeros((d,))
        m[:cfg.q_global] = 1.0
        return m
    return None


def _bits_equal(a, b, msg=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, msg
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                  err_msg=msg)


def _assert_plans_equal(jplan, tplan):
    """Every leaf of a reference nested plan equals the port's."""
    assert tplan.shape == jplan.shape
    assert tplan.stage_units == jplan.stage_units
    for js, ts in zip(jplan.stages, tplan.stages):
        for f in ("node_id", "slot_mask", "parent_row", "flat_pos",
                  "alive"):
            np.testing.assert_array_equal(getattr(ts, f),
                                          np.asarray(getattr(js, f)))
        assert ts.num_sinks == js.num_sinks
        assert (ts.q_budget is None) == (js.q_budget is None)
        if ts.q_budget is not None:
            np.testing.assert_array_equal(ts.q_budget,
                                          np.asarray(js.q_budget))
    for jc, tc in zip(jplan.clustered, tplan.clustered):
        for f in ("node_id", "slot_mask", "parent_row", "flat_pos",
                  "alive", "members"):
            np.testing.assert_array_equal(getattr(tc, f),
                                          np.asarray(getattr(jc, f)))
        assert tc.num_units == jc.num_units
        assert tc.mesh_aligned() == jc.mesh_aligned()
    np.testing.assert_array_equal(tplan.client_alive(),
                                  np.asarray(jplan.client_alive()))


def _stub_inter(lib_tree, lib):
    """Two pods of four; pod 1 unreachable from the PS in the relay tree."""
    inter = lib_tree(parent=(PS, 0), reachable=(True, False))
    return lib.compile_nested([[((0, 1, 2, 3), None), ((4, 5, 6, 7), None)],
                               [((0, 1), inter)]])


def _topologies():
    """(name, reference nested plan, port nested plan)."""
    qb = np.asarray([5, 7, 3, 9, 6, 4, 8, 2], np.int32)
    return [
        ("pod_ring_2x4", jn.pod_ring_nested(2, 4), pod_ring_nested(2, 4)),
        ("pod_ring_4x7", jn.pod_ring_nested(4, 7), pod_ring_nested(4, 7)),
        ("pod_ring_budget", jn.pod_ring_nested(2, 4, q_budget=qb),
         pod_ring_nested(2, 4, q_budget=qb)),
        ("grid_3x4", jn.compile_nested(jr.cluster_routed(
            jg.grid_graph(3, 4), 3)),
         compile_nested(tr.cluster_routed(tg.grid_graph(3, 4), 3))),
        ("walker_exclude", jn.compile_nested(jr.cluster_routed(
            jg.walker_delta(2, 4, gateways=(1, 5)), 2, exclude=[3])),
         compile_nested(tr.cluster_routed(
             tg.walker_delta(2, 4, gateways=(1, 5)), 2, exclude=[3]))),
        ("stub_cluster", _stub_inter(JAggTree, jn),
         _stub_inter(AggTree, tn)),
        ("three_stage", jn.compile_nested(
            [[((0, 1), None), ((2, 3), None), ((4, 5), None)],
             [((0, 1), None), ((2,), None)], [((0, 1), None)]]),
         compile_nested(
             [[((0, 1), None), ((2, 3), None), ((4, 5), None)],
              [((0, 1), None), ((2,), None)], [((0, 1), None)]])),
    ]


TOPOS = _topologies()


@pytest.mark.parametrize("case", TOPOS, ids=[c[0] for c in TOPOS])
def test_plan_leaves_match_reference(case):
    _, jplan, tplan = case
    _assert_plans_equal(jplan, tplan)


# ---------------------------------------------------------------------------
# compile_nested structure (tests/test_nested_plan.py)
# ---------------------------------------------------------------------------

def test_compile_nested_structure():
    nested = pod_ring_nested(2, 4)
    assert nested.num_stages == 2
    assert nested.stage_units == (8, 2)
    assert nested.stages[0].num_sinks == 2
    assert nested.stages[1].num_sinks == 1
    assert nested.q_budget is None
    cl = nested.clustered[0]
    assert cl.num_clusters == 2 and cl.num_units == 4
    assert cl.mesh_aligned() is True
    par = np.asarray(nested.stages[0].parent_row)
    mask = np.asarray(nested.stages[0].slot_mask) > 0
    sinks = par[mask & (par >= 8)]
    assert set(sinks.tolist()) == {8, 9}


def test_compile_nested_validation():
    with pytest.raises(ValueError, match="partition"):
        compile_nested([[((0, 1), None)], [((0,), None)]], num_clients=4)
    with pytest.raises(ValueError, match="two clusters"):
        compile_nested([[((0, 1), None), ((1, 2), None)], [((0, 1), None)]],
                       num_clients=3)
    with pytest.raises(ValueError, match="single cluster"):
        compile_nested([[((0, 1), None), ((2, 3), None)]])
    with pytest.raises(ValueError, match="wiring"):
        NestedPlan(stages=(pod_ring_nested(2, 2).stages[0],
                           compile_nested([[((0, 1, 2), None)]],
                                          num_clients=3).stages[0]))


def test_nested_plan_pad_bit_exact():
    cfg = AggConfig(kind=AggKind.CL_SIA, q=5)
    nested = pod_ring_nested(2, 4)
    big = nested.pad(((5, 3, 2, 5, 2), (2, 1)))
    jbig = jn.pod_ring_nested(2, 4).pad(((5, 3, 2, 5, 2), (2, 1)))
    _assert_plans_equal(jbig, big)
    g, e, w = _inputs(8, 64)
    want = execute_nested(cfg, nested, g, e, w)
    got = execute_nested(cfg, big, g, e, w)
    for a, b in [(want.aggregate, got.aggregate), (want.e_new, got.e_new),
                 (want.stats.bits, got.stats.bits)] + list(
                     zip(want.stage_e_new, got.stage_e_new)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---------------------------------------------------------------------------
# execute_nested semantics
# ---------------------------------------------------------------------------

def test_dense_nested_is_exact_sum():
    k, d = 12, 80
    nested = compile_nested(cluster_routed(tg.grid_graph(3, 4), 3))
    g, e, w = _inputs(k, d)
    res = execute_nested(AggConfig(kind=AggKind.DENSE_IA), nested, g, e, w)
    np.testing.assert_allclose(res.aggregate.numpy(), (g + e).sum(0).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ALL_SPARSE)
def test_mass_conservation_per_stage(kind):
    k, d = 8, 96
    cfg = AggConfig(kind=kind, q=7)
    nested = pod_ring_nested(2, 4)
    g, e, w = _inputs(k, d)
    res = execute_nested(cfg, nested, g, e, w, global_mask=_gmask(cfg, d))
    lhs = (float(res.aggregate.sum()) + float(res.e_new.sum())
           + sum(float(x.sum()) for x in res.stage_e_new))
    np.testing.assert_allclose(lhs, float((g + e).sum()), rtol=1e-4)
    assert res.stats.bits.shape == (k,)
    assert res.stage_stats[0].bits.shape == (2,)


def test_stage_cfgs_override():
    k, d = 8, 64
    nested = pod_ring_nested(2, 4)
    g, e, w = _inputs(k, d)
    cfg0 = AggConfig(kind=AggKind.CL_SIA, q=4)
    cfg1 = AggConfig(kind=AggKind.CL_SIA, q=9)
    res = execute_nested(cfg0, nested, g, e, w, stage_cfgs=[cfg0, cfg1])
    assert int(res.stage_stats[0].nnz_out.max()) <= 9
    assert int(res.stage_stats[0].nnz_out.max()) > 4
    assert int(res.stats.nnz_out.max()) <= 4
    jres = jax.jit(lambda g, e, w: jn.execute_nested(
        JCfg(kind="cl_sia", q=4), jn.pod_ring_nested(2, 4), g, e, w,
        stage_cfgs=[JCfg(kind="cl_sia", q=4), JCfg(kind="cl_sia", q=9)]))(
            g.numpy(), e.numpy(), w.numpy())
    _bits_equal(jres.aggregate, res.aggregate)
    _bits_equal(jres.stage_e_new[0], res.stage_e_new[0])
    _bits_equal(jres.stage_stats[0].nnz_out, res.stage_stats[0].nnz_out)
    with pytest.raises(ValueError, match="stage_cfgs"):
        execute_nested(cfg0, nested, g, e, w, stage_cfgs=[cfg0])
    with pytest.raises(ValueError, match="EF tiers"):
        execute_nested(cfg0, nested, g, e, w, stage_e=())


def test_straggler_and_stub_semantics():
    k, d = 8, 64
    cfg = AggConfig(kind=AggKind.CL_SIA, q=5)
    nested = pod_ring_nested(2, 4)
    g, e, w = _inputs(k, d)
    part = torch.ones((k,))
    part[0] = 0.0
    res = execute_nested(cfg, nested, g, e, w, participate=part)
    np.testing.assert_allclose(res.e_new[0].numpy(), (g[0] + e[0]).numpy(),
                               rtol=1e-6)
    assert float(res.stats.bits[0]) == 0.0


def test_zero_stage_ef_takes_a_device():
    tiers = zero_stage_ef(pod_ring_nested(4, 7), 10, "cpu")
    assert [tuple(t.shape) for t in tiers] == [(4, 10)]
    assert tiers[0].device.type == "cpu" and not tiers[0].any()


# ---------------------------------------------------------------------------
# Parity: execute_nested against the jitted reference
# ---------------------------------------------------------------------------

def _parity_case(kind, impl, topo, seed):
    _, jplan, tplan = next(c for c in TOPOS if c[0] == topo)
    k, d = tplan.num_clients, 96
    kw = dict(kind=kind, q=7, **IMPLS[impl])
    jcfg, tcfg = JCfg(**kw), AggConfig(**kw)
    g, e, w = _inputs(k, d, seed)
    stage_e = [torch.from_numpy(np.random.default_rng(seed + 5).standard_normal(
        (u, d), dtype=np.float32) * np.float32(0.05))
        for u in tplan.stage_units[1:]]
    part = torch.ones((k,))
    part[1] = 0.0
    gm = _gmask(tcfg, d)

    def run_ref(plan, g, e, w, stage_e, part, gm):
        return jn.execute_nested(jcfg, plan, g, e, w, stage_e=stage_e,
                                 participate=part, global_mask=gm)

    want = jax.jit(run_ref)(jplan, g.numpy(), e.numpy(), w.numpy(),
                            [s.numpy() for s in stage_e], part.numpy(),
                            None if gm is None else gm.numpy())
    got = execute_nested(tcfg, tplan, g, e, w, stage_e=stage_e,
                         participate=part, global_mask=gm)
    return want, got


# exact Top-Q on every plan; the threshold searches on the two-stage pod
# ring and the three-stage plan (the walker plan's stub client is a
# participation case, covered under exact Top-Q)
PARITY = ([(topo, "exact") for topo in ("pod_ring_2x4", "walker_exclude",
                                        "three_stage")]
          + [(topo, impl) for topo in ("pod_ring_2x4", "three_stage")
             for impl in ("scan", "hist")])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("topo,impl", PARITY)
def test_execute_nested_matches_reference(kind, impl, topo):
    want, got = _parity_case(kind, impl, topo, seed=3)
    _bits_equal(want.aggregate, got.aggregate, "aggregate")
    _bits_equal(want.e_new, got.e_new, "e_new")
    assert len(want.stage_e_new) == len(got.stage_e_new)
    for s, (a, b) in enumerate(zip(want.stage_e_new, got.stage_e_new)):
        _bits_equal(a, b, f"stage {s + 1} EF")
    for s, (js, ts) in enumerate(zip((want.stats,) + want.stage_stats,
                                     (got.stats,) + got.stage_stats)):
        for f in ("nnz_out", "nnz_global", "nnz_local", "bits"):
            _bits_equal(getattr(js, f), getattr(ts, f), f"stage {s} {f}")
        np.testing.assert_allclose(np.asarray(js.err_sq), ts.err_sq.numpy(),
                                   rtol=ERR_RTOL, err_msg=f"stage {s}")


def test_budgeted_nested_round_matches_reference():
    want, got = _parity_case("sia", "exact", "pod_ring_budget", seed=4)
    _bits_equal(want.aggregate, got.aggregate)
    _bits_equal(want.stats.nnz_out, got.stats.nnz_out)
    _bits_equal(want.stage_stats[0].bits, got.stage_stats[0].bits)


# ---------------------------------------------------------------------------
# Cluster-aware router (the cases of tests/test_nested_plan.py)
# ---------------------------------------------------------------------------

def test_partition_clusters_partitions():
    graph = tg.walker_delta(3, 4)
    clusters = partition_clusters(graph, 3)
    assert sorted(i for c in clusters for i in c) == list(
        range(graph.num_clients))
    assert [list(c) for c in clusters] == [
        list(c) for c in jr.partition_clusters(jg.walker_delta(3, 4), 3)]


def test_cluster_routed_shapes_and_heads():
    graph = tg.grid_graph(2, 4)
    nt = cluster_routed(graph, 2)
    assert nt.num_clients == graph.num_clients and nt.num_clusters == 2
    assert len(nt.intra) == 2 and nt.inter.num_clients == 2
    for tree in nt.intra:
        assert any(p == PS for p in tree.parent)
    assert all(nt.inter.reachable)
    g, e, w = _inputs(nt.num_clients, 40)
    res = execute_nested(AggConfig(kind=AggKind.CL_SIA, q=4),
                         compile_nested(nt), g, e, w)
    assert res.aggregate.shape == (40,)


def test_cluster_routed_exclude_routes_around_dead_relays():
    graph = tg.path_graph(6)
    nt = cluster_routed(graph, clusters=[[0, 1, 2], [3, 4, 5]], exclude=[3])
    tree0 = nt.intra[0]
    assert tree0.reachable[2] is False
    for i, p in enumerate(tree0.parent):
        assert p != 2 or tree0.reachable[i] is False
    assert nt.inter.reachable[1] is False


def test_client_alive_folds_stub_clusters():
    _, jplan, nested = next(c for c in TOPOS if c[0] == "stub_cluster")
    alive = nested.client_alive()
    np.testing.assert_array_equal(alive, [1, 1, 1, 1, 0, 0, 0, 0])
    np.testing.assert_array_equal(alive, np.asarray(jplan.client_alive()))
    on = nested.client_alive("cpu")
    assert isinstance(on, torch.Tensor) and on.tolist() == alive.tolist()
    g = torch.ones((8, 16))
    res = execute_nested(AggConfig(kind=AggKind.DENSE_IA), nested, g,
                         torch.zeros((8, 16)), torch.ones((8,)))
    np.testing.assert_allclose(
        res.aggregate.numpy() / max(float(alive.sum()), 1e-9),
        np.ones((16,)), rtol=1e-6)


def test_cluster_routed_explicit_clusters():
    nt = cluster_routed(tg.grid_graph(2, 4),
                        clusters=[[0, 1, 2, 3], [4, 5, 6, 7]])
    assert nt.clusters == ((0, 1, 2, 3), (4, 5, 6, 7))
    assert compile_nested(nt).clustered[0].mesh_aligned() is True


# ---------------------------------------------------------------------------
# Staged closed forms (§V)
# ---------------------------------------------------------------------------

def test_nested_closed_forms_match_reference():
    for units in ([8, 2], [28, 4], [28, 4, 1]):
        assert cc.nested_cl_sia_bits(units, 7850, 78) == \
            jcc.nested_cl_sia_bits(units, 7850, 78)
        assert cc.nested_cl_tc_sia_bits(units, 7850, 70, 8) == \
            jcc.nested_cl_tc_sia_bits(units, 7850, 70, 8)
    sizes = [list(range(1, 8)) * 4, [1, 2, 3, 4]]
    assert cc.nested_tc_sia_bits_bound(sizes, 7850, 70, 8) == \
        jcc.nested_tc_sia_bits_bound(sizes, 7850, 70, 8)
    assert cc.nested_wire_split((10.0, 3.0, 2.0)) == \
        jcc.nested_wire_split((10.0, 3.0, 2.0))


def test_nested_cl_bits_match_measured():
    k_p, k_d, d = 2, 4, 256
    cfg = AggConfig(kind=AggKind.CL_SIA, q=6)
    g, e, w = _inputs(k_p * k_d, d, seed=3)
    res = execute_nested(cfg, pod_ring_nested(k_p, k_d), g, e, w)
    want = cc.nested_cl_sia_bits([k_p * k_d, k_p], d, cfg.q)
    assert float(res.stats.bits.sum()) == want[0]
    assert float(res.stage_stats[0].bits.sum()) == want[1]
    local, scarce = cc.nested_wire_split(want)
    assert local == want[0] and scarce == want[1]


def test_nested_cl_tc_bits_match_measured():
    k_p, k_d, d = 2, 4, 256
    cfg = AggConfig(kind=AggKind.CL_TC_SIA, q=10)
    g, e, w = _inputs(k_p * k_d, d, seed=5)
    res = execute_nested(cfg, pod_ring_nested(k_p, k_d), g, e, w,
                         global_mask=_gmask(cfg, d))
    want = cc.nested_cl_tc_sia_bits([k_p * k_d, k_p], d, cfg.q_global,
                                    cfg.q_local)
    assert float(res.stats.bits.sum()) == want[0]
    assert float(res.stage_stats[0].bits.sum()) == want[1]


def test_dci_split_matches_hierarchical_model():
    k_p, k_d, d, q = 2, 16, 4096, 10
    payload = q * (cc.idx_bits(d) + 32)
    flat, hier = dci_bytes_flat_vs_hier(k_p, k_d, payload)
    flat2, nested2 = cc.dci_wire_flat_vs_nested(k_p, k_d, d, q)
    assert flat == flat2 and hier == nested2
    assert nested2 * k_d == flat2
    assert (flat2, nested2) == jcc.dci_wire_flat_vs_nested(k_p, k_d, d, q)


def test_nested_tc_bound_reduces_to_tree_bound():
    sizes0 = [list(range(1, 5)), list(range(1, 5))]
    sizes1 = [1, 2]
    per_stage = cc.nested_tc_sia_bits_bound(
        [sizes0[0] + sizes0[1], sizes1], 1000, 20, 5)
    want0 = cc.tc_sia_bits_bound_tree(sizes0[0] + sizes0[1], 1000, 20, 5)
    want1 = cc.tc_sia_bits_bound_tree(sizes1, 1000, 20, 5)
    np.testing.assert_allclose(per_stage, (want0, want1))


# ---------------------------------------------------------------------------
# Schedules and input signatures
# ---------------------------------------------------------------------------

def _small_sim(k=8, **kw):
    pc = dataclasses.replace(PAPER, num_clients=k)
    from repro_torch.data import make_synthetic_mnist, partition_iid
    fed = partition_iid(make_synthetic_mnist(0, k * 20, device="cpu"), k,
                        torch.Generator().manual_seed(2))
    return Simulator(pc, AggConfig(kind=AggKind.CL_SIA, q=5), fed,
                     device="cpu", **kw)


def test_nested_plans_share_one_input_signature():
    """Same-shape nested plans meet one input signature of the round (the
    reference: one jit specialization); a plan of another shape meets a
    second."""
    sim = _small_sim()
    base = pod_ring_nested(2, 4)
    alt = compile_nested([[((0, 2, 4, 6), None), ((1, 3, 5, 7), None)],
                          [((0, 1), None)]])
    assert base.shape == alt.shape
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, sim.d), dtype=np.float32) * np.float32(0.01))
    state = sim.init()
    outs = []
    for plan in (base, alt, base):
        state, log = sim.aggregate_step(state, plan, g)
        outs.append(float(state.flat_w.sum()))
    assert sim.trace_counter.count == 1
    sim.aggregate_step(state, base.pad(((4, 3, 2, 4, 2), (2, 1))), g)
    assert sim.trace_counter.count == 2


def test_topology_schedule_of_nested_plans():
    nts = [tr.cluster_routed(tg.grid_graph(2, 4), 2), pod_ring_nested(2, 4),
           tr.cluster_routed(tg.walker_delta(2, 4), 2)]
    sched = TopologySchedule.from_topologies(nts)
    assert len(sched) == 3
    assert len({sched.plan_at(r).shape for r in range(3)}) == 1
    jsched = JSchedule.from_topologies(
        [jr.cluster_routed(jg.grid_graph(2, 4), 2), jn.pod_ring_nested(2, 4),
         jr.cluster_routed(jg.walker_delta(2, 4), 2)])
    for r in range(3):
        _assert_plans_equal(jsched.plan_at(r), sched.plan_at(r))
    assert sched.raw_at(0) is nts[0] and sched.raw_at(1) is None
    with pytest.raises(ValueError, match="mix"):
        TopologySchedule.from_topologies([pod_ring_nested(2, 4), 8])


def test_schedule_of_nested_plans_starts_the_ef_tiers_at_zero():
    """A run over a nested schedule starts its EF tiers at zero and keeps
    one input signature; the nested topology refuses the other sources
    with the reference's messages."""
    nts = [tr.cluster_routed(tg.grid_graph(2, 4), 2), pod_ring_nested(2, 4)]
    sched = TopologySchedule.from_topologies(nts, round_index=(0, 1, 0, 1))
    sim = _small_sim()
    out = sim.run(4, topology_schedule=sched)
    assert [tuple(e.shape) for e in out["state"].stage_ef] == [(2, sim.d)]
    assert sim.trace_counter.count == 1
    assert out["bits"] == [sum(cc.nested_cl_sia_bits([8, 2], sim.d, 5))] * 4
    nested = _small_sim(nested_topology=pod_ring_nested(2, 4))
    with pytest.raises(ValueError, match="not both"):
        nested.run(1, topology_schedule=sched)
    with pytest.raises(ValueError, match="chain-mode"):
        nested.run(1, order_fn=lambda r, s: list(range(8)))
    with pytest.raises(ValueError, match="nested"):
        nested.run_batched(1, seeds=[0])
    with pytest.raises(ValueError, match="nested"):
        _small_sim().run_batched(1, seeds=[0], topology_schedule=sched)
    with pytest.raises(ValueError, match="not both"):
        _small_sim(nested_topology=pod_ring_nested(2, 4),
                   tree_topology=TreeTopology(tg.walker_delta(2, 4),
                                              "widest"))
    with pytest.raises(ValueError, match="clients"):
        _small_sim(nested_topology=pod_ring_nested(2, 3))


# ---------------------------------------------------------------------------
# Simulator rounds against the reference's
# ---------------------------------------------------------------------------

K = 8
PC = dataclasses.replace(PAPER, num_clients=K)
JPC = dataclasses.replace(JPAPER, num_clients=K)


def _kw(pc):
    return dict(q=pc.q, q_global=pc.q_global, q_local=pc.q_local)


@pytest.fixture(scope="module")
def jfed():
    train = jmnist(jax.random.PRNGKey(0), K * 60)
    return jpartition(jax.random.PRNGKey(2), train, K)


def _port_fed(jfed):
    from repro_torch.data import FederatedData
    return FederatedData(x=torch.from_numpy(np.array(jfed.x)),
                         y=torch.from_numpy(np.array(jfed.y)).long())


def _jgrads(sim):
    """The reference round's minibatch draws and effective gradients."""
    def grads(state):
        rng, kb = jax.random.split(state.rng)
        params = jsim.unflatten_lr(state.flat_w, JPC)
        bx, by = jminibatch(sim.fed, kb, JPC.batch_size)
        g = jax.vmap(lambda x, y: -sim.local_lr * jsim.flatten_lr(
            jax.grad(jsim.lr_loss)(params, x, y)))(bx, by)
        keys = jax.random.split(kb, sim.k)
        idx = jax.vmap(lambda kk: jax.random.randint(
            kk, (JPC.batch_size,), 0, sim.fed.x.shape[1]))(keys)
        return g, idx, rng
    return jax.jit(grads)


def _jaggregate(sim, cfg, state, plan, g):
    """The reference's nested round, given its gradients."""
    def agg(state, plan, g):
        gm, prev = None, state.tcs_prev
        if cfg.kind in ("tc_sia", "cl_tc_sia"):
            gm = jtcs.global_mask(jtcs.TCSState(prev), state.flat_w,
                                  cfg.q_global)
            prev = state.flat_w
        res = jn.execute_nested(cfg, plan, g, state.ef, sim.weights,
                                stage_e=state.stage_ef, global_mask=gm)
        alive = jnp.asarray(plan.client_alive(), sim.weights.dtype)
        flat = state.flat_w + res.aggregate / jnp.maximum(
            jnp.sum(sim.weights * alive), 1e-9)
        return flat, res.e_new, prev, res.stage_e_new, \
            (res.stats,) + res.stage_stats
    return jax.jit(agg)(state, plan, g)


NESTED_SIMS = {
    "walker": (lambda: jr.cluster_routed(
        jg.walker_delta(2, 4, gateways=(1, 5)), 2),
        lambda: tr.cluster_routed(tg.walker_delta(2, 4, gateways=(1, 5)),
                                  2)),
    "stub": (lambda: _stub_inter(JAggTree, jn),
             lambda: _stub_inter(AggTree, tn)),
}


@pytest.mark.parametrize("kind,topo", [(k, "walker") for k in KINDS]
                         + [(k, "stub") for k in ("cl_sia", "tc_sia")])
def test_nested_round_with_reference_state_and_grads_is_bitwise(jfed, kind,
                                                                topo):
    jtopo, ttopo = (f() for f in NESTED_SIMS[topo])
    jcfg = JCfg(kind=kind, **_kw(JPC))
    jsimu = jsim.Simulator(JPC, jcfg, jfed, nested_topology=jtopo)
    sim = Simulator(PC, AggConfig(kind=kind, **_kw(PC)), _port_fed(jfed),
                    nested_topology=ttopo, device="cpu")
    rng = np.random.default_rng(11)
    flat = (rng.standard_normal(JPC.d) * 0.05).astype(np.float32)
    noise = lambda *s: jnp.asarray(  # noqa: E731
        (rng.standard_normal(s) * 1e-3).astype(np.float32))
    state = jsim.SimState(
        round=jnp.int32(2), flat_w=jnp.asarray(flat), ef=noise(K, JPC.d),
        tcs_prev=jnp.asarray(flat) - noise(JPC.d), rng=jax.random.PRNGKey(3),
        stage_ef=tuple(noise(u, JPC.d)
                       for u in jsimu._nested.stage_units[1:]))
    g, _, _ = _jgrads(jsimu)(state)
    flat, e_new, prev, stage_e, stats = _jaggregate(jsimu, jcfg, state,
                                                    jsimu._nested, g)
    new, log = sim.aggregate_step(convert.sim_state(state, "cpu"),
                                  sim._nested, torch.from_numpy(np.array(g)))
    _bits_equal(flat, new.flat_w, "model")
    _bits_equal(e_new, new.ef, "EF")
    _bits_equal(prev, new.tcs_prev, "TCS")
    for a, b in zip(stage_e, new.stage_ef):
        _bits_equal(a, b, "stage EF")
    assert len(log.stats) == len(stats) == 2
    for js, ts in zip(stats, log.stats):
        for f in ("bits", "nnz_out", "nnz_global", "nnz_local"):
            _bits_equal(getattr(js, f), getattr(ts, f), f)
    _bits_equal(np.asarray(jsimu._nested.client_alive()), log.participation)
    assert len(log.stage_ef_mass) == 1
    assert new.round == int(state.round) + 1


@pytest.mark.parametrize("kind", ["cl_sia", "tc_sia"])
def test_nested_loss_curve_with_replayed_minibatches(jfed, kind):
    jtopo, ttopo = (f() for f in NESTED_SIMS["walker"])
    jsimu = jsim.Simulator(JPC, JCfg(kind=kind, **_kw(JPC)), jfed,
                           nested_topology=jtopo)
    sim = Simulator(PC, AggConfig(kind=kind, **_kw(PC)), _port_fed(jfed),
                    nested_topology=ttopo, device="cpu")
    step = jax.jit(jsimu.round_fn())
    draws = _jgrads(jsimu)
    jstate = jsimu.init(0)
    state = convert.sim_state(jstate, "cpu")
    assert [tuple(e.shape) for e in state.stage_ef] == [(2, JPC.d)]
    for r in range(5):
        _, idx, _ = draws(jstate)
        jstate, jlog = step(jstate, jsimu._nested)
        state, log = sim.round_fn(state, sim._nested,
                                  batch_idx=torch.from_numpy(np.array(idx)))
        np.testing.assert_allclose(float(log.loss), float(jlog.loss),
                                   rtol=LOSS_RTOL, err_msg=f"round {r}")
        assert [float(s.bits.sum()) for s in log.stats] == \
            [float(np.sum(s.bits)) for s in jlog.stats]
