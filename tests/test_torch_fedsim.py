"""The port's simulator against the JAX package's, at K = 10 clients.

* One round, with the reference's state and gradients fed in: the new
  model, the EF rows and the §V bits and counts are equal bit for bit.
* Five rounds replaying the reference's minibatch draws: the loss curves
  agree to rtol 1e-4 (the gradients' matrix products sum in another order,
  and the sums feed forward round after round).
* The paper-reproduction assertions of ``tests/test_e2e_fedsim.py`` hold
  for the port on its own synthetic data, at fewer rounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.agg import plan as jplan
from repro.configs import PAPER as JPAPER
from repro.core import tcs as jtcs
from repro.core.algorithms import AggConfig as JCfg
from repro.data.federated import client_minibatch as jminibatch
from repro.data.federated import partition_iid as jpartition
from repro.data.synthetic import make_synthetic_mnist as jmnist
from repro.fed import simulator as jsim
from repro_torch import convert
from repro_torch.agg import compile_plan
from repro_torch.configs import PAPER
from repro_torch.core import comm_cost as cc
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.data import FederatedData, make_synthetic_mnist, partition_iid
from repro_torch.fed import Simulator

torch.set_num_threads(1)

K = 10
PC = dataclasses.replace(PAPER, num_clients=K)
JPC = dataclasses.replace(JPAPER, num_clients=K)
KINDS = ["sia", "re_sia", "cl_sia", "tc_sia", "cl_tc_sia", "dense_ia"]
LOSS_RTOL = 1e-4


def _kw(pc):
    return dict(q=pc.q, q_global=pc.q_global, q_local=pc.q_local)


@pytest.fixture(scope="module")
def jfed():
    train = jmnist(jax.random.PRNGKey(0), K * 120)
    return jpartition(jax.random.PRNGKey(2), train, K)


def _port_fed(jfed):
    return FederatedData(x=torch.from_numpy(np.array(jfed.x)),
                         y=torch.from_numpy(np.array(jfed.y)).long())


def _jgrads(sim):
    """The reference round's minibatch draws and effective gradients, as a
    jitted function of the state."""
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
    """The reference round's aggregation and update, given gradients."""
    def agg(state, plan, g):
        gm, prev = None, state.tcs_prev
        if cfg.kind in ("tc_sia", "cl_tc_sia"):
            gm = jtcs.global_mask(jtcs.TCSState(prev), state.flat_w,
                                  cfg.q_global)
            prev = state.flat_w
        res = jplan.execute(cfg, plan, g, state.ef, sim.weights,
                            global_mask=gm)
        part = jnp.asarray(plan.alive, sim.weights.dtype)
        flat = state.flat_w + res.aggregate / jnp.maximum(
            jnp.sum(sim.weights * part), 1e-9)
        return flat, res.e_new, prev, res.stats
    return jax.jit(agg)(state, plan, g)


@pytest.mark.parametrize("kind", KINDS)
def test_one_round_with_reference_state_and_grads_is_bitwise(jfed, kind):
    jcfg = JCfg(kind=kind, **_kw(JPC))
    jsimu = jsim.Simulator(JPC, jcfg, jfed)
    jplan_ = jplan.compile_plan(K)
    # a mid-training state: a moving model and banked EF mass
    rng = np.random.default_rng(11)
    flat = (rng.standard_normal(JPC.d) * 0.05).astype(np.float32)
    state = jsim.SimState(
        round=jnp.int32(2), flat_w=jnp.asarray(flat),
        ef=jnp.asarray((rng.standard_normal((K, JPC.d)) * 1e-3).astype(
            np.float32)),
        tcs_prev=jnp.asarray(flat - (rng.standard_normal(JPC.d) * 1e-3)
                             .astype(np.float32)),
        rng=jax.random.PRNGKey(3))
    g, _, _ = _jgrads(jsimu)(state)
    flat, e_new, prev, stats = _jaggregate(jsimu, jcfg, state, jplan_, g)

    sim = Simulator(PC, AggConfig(kind=kind, **_kw(PC)), _port_fed(jfed),
                    device="cpu")
    new, log = sim.aggregate_step(convert.sim_state(state, "cpu"),
                                  convert.agg_plan(jplan_),
                                  torch.from_numpy(np.array(g)))
    for a, b in ((flat, new.flat_w), (e_new, new.ef), (prev, new.tcs_prev),
                 (stats.bits, log.stats[0].bits),
                 (stats.nnz_out, log.stats[0].nnz_out),
                 (stats.nnz_local, log.stats[0].nnz_local)):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert new.round == int(state.round) + 1


@pytest.mark.parametrize("kind", ["cl_sia", "tc_sia", "cl_tc_sia"])
def test_loss_curve_with_replayed_minibatches(jfed, kind):
    jcfg = JCfg(kind=kind, **_kw(JPC))
    jsimu = jsim.Simulator(JPC, jcfg, jfed)
    jplan_ = jplan.compile_plan(K)
    step = jax.jit(jsimu.round_fn())
    jstate = jsimu.init(0)
    sim = Simulator(PC, AggConfig(kind=kind, **_kw(PC)), _port_fed(jfed),
                    device="cpu")
    state = convert.sim_state(jstate, "cpu")
    plan = convert.agg_plan(jplan_)
    draws = _jgrads(jsimu)
    for _ in range(5):
        _, idx, _ = draws(jstate)
        jstate, jlog = step(jstate, jplan_)
        state, log = sim.round_fn(state, plan,
                                  batch_idx=torch.from_numpy(np.array(idx)))
        np.testing.assert_allclose(float(log.loss), float(jlog.loss),
                                   rtol=LOSS_RTOL)


# --- the paper-reproduction checks, on the port's own data --------------

@pytest.fixture(scope="module")
def fed_data():
    train = make_synthetic_mnist(0, K * 120, device="cpu")
    test = make_synthetic_mnist(1, 600, device="cpu")
    return partition_iid(train, K, torch.Generator().manual_seed(2)), test


def _sim(kind, fed):
    return Simulator(PC, AggConfig(kind=kind, **_kw(PC)), fed, device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_all_algorithms_converge(fed_data, kind):
    fed, test = fed_data
    out = _sim(kind, fed).run(60, test_x=test.x, test_y=test.y,
                              eval_every=59)
    # CL-TC-SIA converges slower (paper Fig 3) — relaxed bar
    bar = 0.75 if kind == "cl_tc_sia" else 0.9
    assert out["accuracy"][-1][1] > bar, (kind, out["accuracy"])
    assert out["loss"][-1] < out["loss"][0]


def test_comm_cost_ordering_and_closed_forms(fed_data):
    """Fig 2a ordering: CL-TC < CL < TC < SIA ≈ RE < dense IA; CL-SIA bits
    equal the closed form every round; Fig 2b efficiency."""
    fed, _ = fed_data
    outs = {kind: _sim(kind, fed).run(20) for kind in KINDS}
    bits = {kind: np.mean(out["bits"][5:]) for kind, out in outs.items()}
    assert bits["cl_tc_sia"] < bits["cl_sia"] < bits["tc_sia"] < bits["sia"]
    assert bits["sia"] == pytest.approx(bits["re_sia"], rel=0.15)
    assert bits["sia"] < bits["dense_ia"]
    expect = cc.cl_sia_bits(K, PC.d, PC.q)
    assert all(b == expect for b in outs["cl_sia"]["bits"][2:])
    norm = cc.normalized_efficiency(outs["cl_sia"]["bits"][-1], PC.d, PC.q)
    assert norm == pytest.approx(K, rel=1e-6)
    assert cc.normalized_efficiency(bits["sia"], PC.d, PC.q) > 1.5 * K


def test_star_and_permuted_chain_keep_cl_sia_bits(fed_data):
    fed, _ = fed_data
    sim = _sim("cl_sia", fed)
    order = np.random.default_rng(0).permutation(K)
    out = sim.run(6, order_fn=lambda r, s: order)
    assert out["bits"][-1] == cc.cl_sia_bits(K, PC.d, PC.q)
    out = sim.run(4, participate_fn=lambda r, s: np.r_[0.0, np.ones(K - 1)])
    assert out["bits"][-1] <= cc.cl_sia_bits(K, PC.d, PC.q)


def test_converted_params_give_the_reference_loss(jfed):
    rng = np.random.default_rng(9)
    params = {"w": rng.standard_normal((784, 10)).astype(np.float32) * 0.01,
              "b": rng.standard_normal(10).astype(np.float32) * 0.1}
    x, y = np.array(jfed.x[0]), np.array(jfed.y[0])
    want = float(jax.jit(jsim.lr_loss)(params, x, y))
    tp = convert.lr_params(params, "cpu")
    from repro_torch.fed import simulator as tsim
    got = float(tsim.lr_loss(tp, torch.from_numpy(x),
                             torch.from_numpy(y).long()))
    assert got == pytest.approx(want, rel=1e-6)
    np.testing.assert_array_equal(
        np.asarray(jsim.flatten_lr(params)), tsim.flatten_lr(tp).numpy())


# --- threshold Top-Q through the simulator ---------------------------------

THRESHOLD = [("scan", 3), ("hist", 2)]


@pytest.mark.parametrize("impl", THRESHOLD, ids=[i for i, _ in THRESHOLD])
@pytest.mark.parametrize("kind", ["sia", "re_sia", "cl_sia", "tc_sia",
                                  "cl_tc_sia"])
def test_threshold_rounds_with_reference_grads_are_bitwise(jfed, kind,
                                                           impl):
    """Three rounds under threshold Top-Q, each fed the reference round's
    gradients: the models, EF rows, TCS state and §V counts and bits stay
    equal bit for bit, round after round."""
    tau_impl, rounds = impl
    kw = dict(kind=kind, topq_impl="threshold", tau_impl=tau_impl,
              hist_rounds=rounds)
    jcfg = JCfg(**kw, **_kw(JPC))
    jsimu = jsim.Simulator(JPC, jcfg, jfed)
    jplan_ = jplan.compile_plan(K)
    sim = Simulator(PC, AggConfig(**kw, **_kw(PC)), _port_fed(jfed),
                    device="cpu")
    plan = convert.agg_plan(jplan_)
    draws = _jgrads(jsimu)
    jstate = jsimu.init(0)
    state = convert.sim_state(jstate, "cpu")
    for r in range(3):
        g, _, rng = draws(jstate)
        flat, e_new, prev, stats = _jaggregate(jsimu, jcfg, jstate, jplan_,
                                               g)
        state, log = sim.aggregate_step(state, plan,
                                        torch.from_numpy(np.array(g)))
        for a, b in ((flat, state.flat_w), (e_new, state.ef),
                     (prev, state.tcs_prev),
                     (stats.bits, log.stats[0].bits),
                     (stats.nnz_out, log.stats[0].nnz_out),
                     (stats.nnz_local, log.stats[0].nnz_local)):
            a, b = np.asarray(a), b.numpy()
            np.testing.assert_array_equal(a.view(np.int32),
                                          b.view(np.int32),
                                          err_msg=f"round {r}")
        jstate = jstate._replace(round=jstate.round + 1, flat_w=flat,
                                 ef=e_new, tcs_prev=prev, rng=rng)


# --- RoundLog's structure (ROADMAP C1) --------------------------------------

def test_round_log_has_the_reference_structure(jfed):
    """One round's log from each package: the same fields in the same
    order, the same tuple lengths (``stats`` one stage for a flat plan,
    ``stage_ef_mass`` none) and the same leaf shapes."""
    jcfg = JCfg(kind="cl_sia", **_kw(JPC))
    jsimu = jsim.Simulator(JPC, jcfg, jfed)
    _, jlog = jax.jit(jsimu.round_fn())(jsimu.init(0), jplan.compile_plan(K))
    sim = Simulator(PC, AggConfig(kind="cl_sia", **_kw(PC)),
                    _port_fed(jfed), device="cpu")
    _, log = sim.round_fn(sim.init(), compile_plan(K),
                          generator=torch.Generator().manual_seed(0))
    assert type(log).__name__ == type(jlog).__name__ == "RoundLog"
    assert log._fields == jlog._fields
    for jv, tv in zip(jlog, log):
        assert isinstance(tv, tuple) == isinstance(jv, tuple)
        if isinstance(jv, tuple):
            assert len(tv) == len(jv)
            for js, ts in zip(jv, tv):
                assert ts._fields == js._fields
                assert [tuple(x.shape) for x in ts] == \
                    [tuple(np.shape(x)) for x in js]
        else:
            assert tuple(tv.shape) == tuple(np.shape(jv))


# --- the Dirichlet non-IID split --------------------------------------------

@pytest.mark.parametrize("alpha", [0.1, 0.3, 0.5])
def test_partition_dirichlet_matches_reference(alpha):
    """Given the integer the reference draws from its key, the port's
    numpy calls make the same split bit for bit."""
    from repro.data.federated import partition_dirichlet as jdirichlet
    from repro_torch.data import Dataset, partition_dirichlet
    train = jmnist(jax.random.PRNGKey(5), K * 40)
    key = jax.random.PRNGKey(6)
    want = jdirichlet(key, train, K, alpha=alpha)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    data = Dataset(x=torch.from_numpy(np.array(train.x)),
                   y=torch.from_numpy(np.array(train.y)).long())
    got = partition_dirichlet(data, K, seed, alpha=alpha)
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    assert got.x.shape == (K, 40, 784)


def test_dirichlet_noniid_still_converges(fed_data):
    from repro_torch.data import partition_dirichlet
    _, test = fed_data
    train = make_synthetic_mnist(5, K * 120, device="cpu")
    fed = partition_dirichlet(train, K, 6, alpha=0.3)
    out = _sim("cl_sia", fed).run(150, test_x=test.x, test_y=test.y,
                                  eval_every=149)
    assert out["accuracy"][-1][1] > 0.85, out["accuracy"]


# --- routed trees, relay failures and topology schedules --------------------

def _walker(lib):
    return lib.walker_delta(3, 4, gateways=(1, 7))


FAILURES = {1: ([0], []), 3: ([], [0])}
LINK_EVENTS = {1: ([(1, 5), (1, 2)], []), 3: ([], [(1, 5), (1, 2)])}


@pytest.fixture(scope="module")
def tree_case():
    """A Walker-delta shell of 12 satellites, its data, and the plan of
    every round of both timelines, built by each package itself."""
    from repro.agg import TopologySchedule as JSchedule
    from repro.fed.topology import FailureSchedule as JFail
    from repro.fed.topology import TreeTopology as JTree
    from repro.topo import graph as jg
    from repro_torch.agg import TopologySchedule
    from repro_torch.fed.topology import FailureSchedule, TreeTopology
    from repro_torch.topo import graph as tg

    k = 12
    train = jmnist(jax.random.PRNGKey(0), k * 60)
    fed = jpartition(jax.random.PRNGKey(2), train, k)
    jtopo, ttopo = JTree(_walker(jg), "widest"), TreeTopology(_walker(tg),
                                                              "widest")
    jfail, tfail = JFail(k, FAILURES), FailureSchedule(k, FAILURES)
    jsched = JSchedule.from_link_events(_walker(jg), LINK_EVENTS, rounds=5,
                                        routing="widest")
    tsched = TopologySchedule.from_link_events(_walker(tg), LINK_EVENTS,
                                               rounds=5, routing="widest")
    plans = {
        "failure": [(jtopo.plan(dead=tuple(jfail.dead_at(r))),
                     ttopo.plan(dead=tuple(tfail.dead_at(r))))
                    for r in range(5)],
        "schedule": [(jsched.plan_at(r), tsched.plan_at(r))
                     for r in range(5)]}
    return dict(k=k, fed=fed, jtopo=jtopo, ttopo=ttopo, plans=plans,
                jfail=jfail, tfail=tfail, jsched=jsched, tsched=tsched)


def _tree_sims(case, kind):
    k = case["k"]
    jpc, pc = (dataclasses.replace(c, num_clients=k) for c in (JPAPER, PAPER))
    jsimu = jsim.Simulator(jpc, JCfg(kind=kind, **_kw(jpc)), case["fed"])
    sim = Simulator(pc, AggConfig(kind=kind, **_kw(pc)),
                    _port_fed(case["fed"]), device="cpu")
    return jsimu, sim


@pytest.mark.parametrize("mode", ["failure", "schedule"])
def test_tree_plans_match_reference(tree_case, mode):
    dead_round = [convert.agg_plan(j) for j, _ in tree_case["plans"][mode]]
    for want, (_, got) in zip(dead_round, tree_case["plans"][mode]):
        for field in ("node_id", "slot_mask", "parent_row", "flat_pos",
                      "alive"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
    shapes = [p.shape for _, p in tree_case["plans"][mode]]
    alive = [float(p.alive.min()) for _, p in tree_case["plans"][mode]]
    if mode == "failure":       # the dead relay's round re-routes
        assert shapes[0] != shapes[1] and alive == [1, 0, 0, 1, 1]
    else:                       # padded to one (L, W) with valid == 0 lanes
        assert len(set(shapes)) == 1
        assert min(float(p.slot_mask.mean())
                   for _, p in tree_case["plans"][mode]) < 1.0


@pytest.mark.parametrize("mode", ["failure", "schedule"])
@pytest.mark.parametrize("kind", ["sia", "re_sia", "cl_sia", "tc_sia",
                                  "cl_tc_sia"])
def test_tree_round_with_reference_grads_is_bitwise(tree_case, mode, kind):
    """Round 1 of each timeline (client 0 dead, or links down): the
    reference's state and gradients in, the model, EF rows and §V counts
    out bit for bit, each package on the plan it built itself."""
    jsimu, sim = _tree_sims(tree_case, kind)
    jplan_, tplan = tree_case["plans"][mode][1]
    k = tree_case["k"]
    rng = np.random.default_rng(12)
    flat = (rng.standard_normal(JPC.d) * 0.05).astype(np.float32)
    state = jsim.SimState(
        round=jnp.int32(1), flat_w=jnp.asarray(flat),
        ef=jnp.asarray((rng.standard_normal((k, JPC.d)) * 1e-3).astype(
            np.float32)),
        tcs_prev=jnp.asarray(flat - (rng.standard_normal(JPC.d) * 1e-3)
                             .astype(np.float32)),
        rng=jax.random.PRNGKey(4))
    g, _, _ = _jgrads(jsimu)(state)
    flat, e_new, prev, stats = _jaggregate(jsimu, jsimu.agg, state, jplan_,
                                           g)
    new, log = sim.aggregate_step(convert.sim_state(state, "cpu"), tplan,
                                  torch.from_numpy(np.array(g)))
    for a, b in ((flat, new.flat_w), (e_new, new.ef), (prev, new.tcs_prev),
                 (stats.bits, log.stats[0].bits),
                 (stats.nnz_out, log.stats[0].nnz_out),
                 (stats.nnz_local, log.stats[0].nnz_local),
                 (jplan_.alive, log.participation)):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("mode", ["failure", "schedule"])
@pytest.mark.parametrize("kind", ["sia", "cl_sia"])
def test_tree_loss_curve_with_replayed_minibatches(tree_case, mode, kind):
    """Five rounds through both timelines, the port replaying the
    reference's minibatch draws: losses to rtol 1e-4."""
    jsimu, sim = _tree_sims(tree_case, kind)
    step = jax.jit(jsimu.round_fn())
    draws = _jgrads(jsimu)
    jstate = jsimu.init(0)
    state = convert.sim_state(jstate, "cpu")
    for r, (jp, tp) in enumerate(tree_case["plans"][mode]):
        _, idx, _ = draws(jstate)
        jstate, jlog = step(jstate, jp)
        state, log = sim.round_fn(state, tp,
                                  batch_idx=torch.from_numpy(np.array(idx)))
        np.testing.assert_allclose(float(log.loss), float(jlog.loss),
                                   rtol=LOSS_RTOL, err_msg=f"round {r}")


@pytest.mark.parametrize("mode", ["failure", "schedule"])
def test_run_under_tree_timelines_gives_the_reference_bits(tree_case, mode):
    """``run`` itself: CL-SIA's bits per round equal the reference run's
    and the closed form over each round's live uplinks (the dead relay
    leaves the route), and the loss falls."""
    jsimu, _ = _tree_sims(tree_case, "cl_sia")
    k = tree_case["k"]
    pc = dataclasses.replace(PAPER, num_clients=k)
    kw = dict(local_lr=pc.lr, device="cpu")
    if mode == "failure":
        jsimu = jsim.Simulator(jsimu.pc, jsimu.agg, tree_case["fed"],
                               tree_topology=tree_case["jtopo"])
        want = jsimu.run(5, failure_schedule=tree_case["jfail"])
        sim = Simulator(pc, AggConfig(kind="cl_sia", **_kw(pc)),
                        _port_fed(tree_case["fed"]),
                        tree_topology=tree_case["ttopo"], **kw)
        got = sim.run(5, failure_schedule=tree_case["tfail"])
        live = [k, k - 1, k - 1, k, k]
    else:
        want = jsimu.run(5, topology_schedule=tree_case["jsched"])
        sim = Simulator(pc, AggConfig(kind="cl_sia", **_kw(pc)),
                        _port_fed(tree_case["fed"]), **kw)
        got = sim.run(5, topology_schedule=tree_case["tsched"])
        live = [k] * 5
    assert got["bits"] == want["bits"]
    assert got["bits"] == [cc.cl_sia_bits_tree(n, pc.d, pc.q) for n in live]
    assert got["loss"][-1] < got["loss"][0]


@pytest.mark.parametrize("kind", ["sia", "cl_sia", "tc_sia"])
def test_padded_plan_gives_the_same_round(tree_case, kind):
    """The plan of a dead-relay round and the same plan padded as the
    reference's plan cache pads it: the same bits, EF rows and model bit
    for bit (padding lanes run the zero row and are never added)."""
    _, sim = _tree_sims(tree_case, kind)
    _, plan = tree_case["plans"]["failure"][1]
    big = plan.pad((plan.shape[0] + 2, plan.shape[1] + 3))
    rng = np.random.default_rng(3)
    k, d = tree_case["k"], PC.d
    grads = torch.from_numpy(rng.standard_normal((k, d), dtype=np.float32)
                             * np.float32(0.01))
    state = sim.init()._replace(ef=torch.from_numpy(
        rng.standard_normal((k, d), dtype=np.float32) * np.float32(1e-3)))
    outs = [sim.aggregate_step(state, p, grads) for p in (plan, big)]
    (s1, l1), (s2, l2) = outs
    for a, b in ((s1.flat_w, s2.flat_w), (s1.ef, s2.ef),
                 (l1.stats[0].bits, l2.stats[0].bits),
                 (l1.stats[0].nnz_out, l2.stats[0].nnz_out),
                 (l1.loss, l2.loss)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_run_exclusivity_errors(tree_case):
    """The reference's messages for the reference's combinations, and the
    port's fixed ``topology`` taken alone."""
    k = tree_case["k"]
    pc = dataclasses.replace(PAPER, num_clients=k)
    fed = _port_fed(tree_case["fed"])
    cfg = AggConfig(kind="cl_sia", **_kw(pc))
    chain = Simulator(pc, cfg, fed, device="cpu")
    tree = Simulator(pc, cfg, fed, tree_topology=tree_case["ttopo"],
                     device="cpu")
    order = lambda r, s: np.arange(k)            # noqa: E731
    sched = tree_case["tsched"]
    cases = [
        (chain, dict(failure_schedule=tree_case["tfail"]),
         "failure_schedule needs tree_topology"),
        (tree, dict(order_fn=order), "order_fn is a chain-mode knob"),
        (chain, dict(order_fn=order, topology_schedule=sched),
         "order_fn is a chain-mode knob"),
        (tree, dict(topology_schedule=sched),
         "pass either tree_topology/nested_topology or topology_schedule"),
        (chain, dict(topology=k, order_fn=order), "taken alone"),
        (chain, dict(topology=k, topology_schedule=sched), "taken alone"),
        (tree, dict(topology=k), "taken alone"),
    ]
    for sim, kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            sim.run(1, **kw)
    jsimu, _ = _tree_sims(tree_case, "cl_sia")
    with pytest.raises(ValueError, match="failure_schedule needs"):
        jsimu.run(1, failure_schedule=tree_case["jfail"])
    with pytest.raises(ValueError, match="12 clients, data has 10"):
        Simulator(PC, cfg, _port_fed(jpartition(
            jax.random.PRNGKey(2), jmnist(jax.random.PRNGKey(0), 100), K)),
            tree_topology=tree_case["ttopo"], device="cpu")
