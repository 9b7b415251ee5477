"""The port's client-per-rank device backend (``repro_torch.agg.device``)
against the JAX package and against the port's own host executor.

The reference proves ``execute_sharded`` bit-exact to host
``repro.agg.execute`` on 8 fake host devices (``tests/test_device_plan.py``,
``CLIENTS_EQUIV``). Here the same cases run in-process on
``client_mesh(8, devices=["cpu"] * 8)``, each fed the same numpy arrays:

* ``execute_sharded`` against jitted ``repro.agg.execute`` for the six
  kinds over the chain, a permuted chain, a routed grid tree and a hand
  tree, all padded to one schedule shape, with stragglers — the aggregate,
  EF rows, ``nnz_*`` and ``bits`` bit for bit, ``err_sq`` (a row sum in
  XLA's order) to rtol 1e-6; and against the port's host ``execute`` bit
  for bit, ``err_sq`` included, on padded and unpadded plans, stub and
  budgeted plans, forest plans and threshold Top-Q;
* the compact and dense wires give the same round; bf16 gradients and EF
  stay bit-exact; a bf16 compact wire stays within 2e-2 relative of the
  float32 wire with the same support and halves the ω bits (the
  client-path twin of ``tests/test_wire_quant.py``);
* ``Simulator(backend="device")`` equals ``backend="host"`` bit for bit
  over whole runs on the chain with stragglers and on a routed tree
  through a relay failure;
* the mesh: explicit device lists, sizes, wire formats and their errors.

Sizes: K = 8 clients, d = 97 (the reference's own test) and 257.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import agg as jagg
from repro.core.algorithms import AggConfig as JCfg
from repro.topo import graph as jg
from repro.topo.routing import shortest_path_tree as jshortest
from repro.topo.tree import PS as JPS
from repro.topo.tree import AggTree as JTree
from repro_torch.agg import compile_plan, execute, pod_ring_nested
from repro_torch.agg.device import (ClientMesh, _use_compact, client_mesh,
                                    execute_sharded)
from repro_torch.configs import PAPER
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.data import make_synthetic_mnist, partition_iid
from repro_torch.fed import Simulator
from repro_torch.fed.topology import FailureSchedule, TreeTopology
from repro_torch.topo import graph as tg
from repro_torch.topo.routing import shortest_path_tree
from repro_torch.topo.tree import PS, AggTree

torch.set_num_threads(1)

K, D = 8, 97
KINDS = ["sia", "re_sia", "cl_sia", "tc_sia", "cl_tc_sia", "dense_ia"]
PARENT = (PS, 0, 1, 1, 3, 0, 5, 2)
ORDER = [3, 1, 0, 6, 4, 2, 5, 7]
PART = np.asarray([1, 0, 1, 1, 1, 0, 1, 1], np.float32)
ERR_RTOL = 1e-6
MESH = client_mesh(K, devices=["cpu"] * K)


def _inputs(seed=0, d=D):
    r = np.random.default_rng(seed)
    return (r.standard_normal((K, d)).astype(np.float32),
            (0.1 * r.standard_normal((K, d))).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfgs(kind, **kw):
    """(port cfg, reference cfg): the port's fused path on the CPU runs
    the kernels' plain versions, the reference's ``"ref"`` mode the same
    structure with its jnp bodies."""
    kw = dict(kind=kind, q=9, **kw)
    return AggConfig(**kw), JCfg(kernel_mode="ref", **kw)


def _gmask(cfg, d=D):
    gm = np.zeros((d,), np.float32)
    if cfg.kind in (AggKind.TC_SIA, AggKind.CL_TC_SIA):
        gm[:cfg.q_global] = 1.0
    return gm


def _topologies():
    """name → (port topology, reference topology)."""
    return {
        "chain": (K, K),
        "perm": (np.asarray(ORDER), np.asarray(ORDER, np.int32)),
        "routed": (shortest_path_tree(tg.grid_graph(2, 4)),
                   jshortest(jg.grid_graph(2, 4))),
        "hand": (AggTree(parent=PARENT),
                 JTree(parent=tuple(JPS if p == PS else p for p in PARENT))),
    }


@functools.lru_cache(maxsize=None)
def _plans():
    """name → (port plan, reference plan), padded to one shared shape as
    the reference's schedule pads them."""
    own = {n: (compile_plan(t), jagg.compile_plan(jt))
           for n, (t, jt) in _topologies().items()}
    shape = tuple(np.max([p.shape for p, _ in own.values()], axis=0))
    return {n: (p.pad(shape), jp.pad(shape)) for n, (p, jp) in own.items()}


@functools.partial(jax.jit, static_argnums=0)
def _jexecute(cfg, plan, g, e, w, gm, part):
    return jagg.execute(cfg, plan, g, e, w, global_mask=gm, participate=part)


def _same(a, b, msg=""):
    a = a.detach().cpu() if isinstance(a, torch.Tensor) else a
    b = b.detach().cpu() if isinstance(b, torch.Tensor) else b
    if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
        a = a.view(torch.int16)
    if isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16:
        b = b.view(torch.int16)
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (msg, a.dtype, b.dtype)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _assert_round(want, got, err_rtol=None, msg=""):
    """Aggregate, EF rows and every HopStats field bit for bit; with
    ``err_rtol``, ``err_sq`` to that tolerance instead."""
    _same(want.aggregate, got.aggregate, msg + " aggregate")
    _same(want.e_new, got.e_new, msg + " e_new")
    for f in ("nnz_out", "nnz_global", "nnz_local", "bits"):
        _same(getattr(want.stats, f), getattr(got.stats, f), msg + " " + f)
    if err_rtol is None:
        _same(want.stats.err_sq, got.stats.err_sq, msg + " err_sq")
    else:
        np.testing.assert_allclose(np.asarray(want.stats.err_sq),
                                   got.stats.err_sq.numpy(), rtol=err_rtol,
                                   atol=1e-6, err_msg=msg)


# ---------------------------------------------------------------------------
# execute_sharded against the reference and the port's host execute
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topo", ["chain", "perm", "routed", "hand"])
@pytest.mark.parametrize("kind", KINDS)
def test_execute_sharded_matches_reference_execute(kind, topo):
    cfg, jcfg = _cfgs(kind)
    plan, jplan = _plans()[topo]
    g, e = _inputs()
    w = np.ones((K,), np.float32)
    gm = _gmask(cfg)
    want = _jexecute(jcfg, jplan, g, e, w, gm, PART)
    host = execute(cfg, plan, _t(g), _t(e), _t(w), global_mask=_t(gm),
                   participate=_t(PART))
    got = execute_sharded(cfg, plan, _t(g), _t(e), _t(w), mesh=MESH,
                          global_mask=_t(gm), participate=_t(PART))
    _assert_round(want, got, ERR_RTOL, f"{kind}/{topo} vs reference")
    _assert_round(host, got, None, f"{kind}/{topo} vs host")


@pytest.mark.parametrize("mode", ["auto", "never"])
@pytest.mark.parametrize("topo", ["chain", "perm", "routed", "hand"])
@pytest.mark.parametrize("kind", KINDS)
def test_execute_sharded_equals_host_execute_on_unpadded_plans(kind, topo,
                                                               mode):
    cfg = AggConfig(kind=kind, q=9, kernel_mode=mode, err_sq_mode="kernel")
    plan = compile_plan(_topologies()[topo][0])
    g, e = _inputs(3, d=257)
    w = _t(np.linspace(0.5, 2.0, K).astype(np.float32))
    gm = _t(_gmask(cfg, 257))
    for part in (None, _t(PART)):
        host = execute(cfg, plan, _t(g), _t(e), w, global_mask=gm,
                       participate=part)
        got = execute_sharded(cfg, plan, _t(g), _t(e), w, mesh=MESH,
                              global_mask=gm, participate=part)
        _assert_round(host, got, None, f"{kind}/{topo}/{mode}")


@pytest.mark.parametrize("kind", ["sia", "cl_sia", "tc_sia", "cl_tc_sia"])
def test_stub_and_budgeted_plans_equal_host_execute(kind):
    """A stranded stub (``alive = 0``) and per-client dynamic budgets."""
    cfg = AggConfig(kind=kind, q=9)
    stub = AggTree(parent=(PS, 0, 1, 1, 3, 0, PS, 2),
                   reachable=(True,) * 6 + (False, True))
    qb = np.asarray([5, 7, 3, 9, 6, 4, 8, 2], np.int32)
    g, e = _inputs(5)
    gm = _t(_gmask(cfg))
    for plan in (compile_plan(stub), compile_plan(AggTree(parent=PARENT),
                                                  q_budget=qb)):
        host = execute(cfg, plan, _t(g), _t(e), torch.ones(K),
                       global_mask=gm, participate=_t(PART))
        got = execute_sharded(cfg, plan, _t(g), _t(e), torch.ones(K),
                              mesh=MESH, global_mask=gm,
                              participate=_t(PART))
        _assert_round(host, got, None, kind)


@pytest.mark.parametrize("impl", ["scan", "hist"])
@pytest.mark.parametrize("kind", ["sia", "re_sia", "cl_sia", "tc_sia",
                                  "cl_tc_sia"])
def test_threshold_topq_equals_host_execute(kind, impl):
    cfg = AggConfig(kind=kind, q=9, topq_impl="threshold", tau_impl=impl,
                    hist_rounds=3 if impl == "scan" else 2)
    plan = _plans()["routed"][0]
    g, e = _inputs(7, d=257)
    gm = _t(_gmask(cfg, 257))
    host = execute(cfg, plan, _t(g), _t(e), torch.ones(K), global_mask=gm,
                   participate=_t(PART))
    got = execute_sharded(cfg, plan, _t(g), _t(e), torch.ones(K), mesh=MESH,
                          global_mask=gm, participate=_t(PART))
    _assert_round(host, got, None, f"{kind}/{impl}")


@pytest.mark.parametrize("impl", ["scan", "hist"])
@pytest.mark.parametrize("kind", ["cl_sia", "tc_sia"])
def test_threshold_topq_matches_reference_execute(kind, impl):
    kw = dict(topq_impl="threshold", tau_impl=impl,
              hist_rounds=3 if impl == "scan" else 2)
    cfg, jcfg = _cfgs(kind, **kw)
    plan, jplan = _plans()["hand"]
    g, e = _inputs(11)
    w = np.ones((K,), np.float32)
    gm = _gmask(cfg)
    want = _jexecute(jcfg, jplan, g, e, w, gm, PART)
    got = execute_sharded(cfg, plan, _t(g), _t(e), _t(w), mesh=MESH,
                          global_mask=_t(gm), participate=_t(PART))
    _assert_round(want, got, ERR_RTOL, f"{kind}/{impl}")


def test_forest_plan_returns_sink_ordered_rows():
    """A forest plan (the stage-0 form of a nested plan, two sinks) gives
    ``[R, d]`` sink rows, the host's."""
    cfg = AggConfig(kind="cl_sia", q=9)
    plan = pod_ring_nested(2, 4).stages[0]
    assert plan.num_sinks == 2
    g, e = _inputs(13)
    host = execute(cfg, plan, _t(g), _t(e), torch.ones(K),
                   participate=_t(PART))
    got = execute_sharded(cfg, plan, _t(g), _t(e), torch.ones(K), mesh=MESH,
                          participate=_t(PART))
    assert got.aggregate.shape == (2, D)
    _assert_round(host, got, None, "forest")


# ---------------------------------------------------------------------------
# Wire formats and dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topo", ["chain", "routed"])
@pytest.mark.parametrize("kind", ["cl_sia", "cl_tc_sia"])
def test_compact_wire_equals_dense_wire(kind, topo):
    cfg, jcfg = _cfgs(kind)
    plan, jplan = _plans()[topo]
    g, e = _inputs(17)
    w = np.ones((K,), np.float32)
    gm = _gmask(cfg)
    # all alive, no stragglers: the compact wire is safe on any plan
    assert _use_compact(cfg, D, plan, False, "auto")
    want = _jexecute(jcfg, jplan, g, e, w, gm, None)
    rounds = {wire: execute_sharded(cfg, plan, _t(g), _t(e), _t(w),
                                    mesh=MESH, global_mask=_t(gm),
                                    wire=wire)
              for wire in ("compact", "dense", "auto")}
    for wire, got in rounds.items():
        _assert_round(rounds["dense"], got, None, wire)
        _assert_round(want, got, ERR_RTOL, wire)


def test_auto_wire_takes_compact_only_where_the_bound_holds():
    cfg = AggConfig(kind="cl_sia", q=9)
    chain, tree = _plans()["chain"][0], _plans()["hand"][0]
    assert _use_compact(cfg, D, chain, True, "auto")        # chain: any
    assert _use_compact(cfg, D, tree, False, "auto")        # all transmit
    assert not _use_compact(cfg, D, tree, True, "auto")     # stragglers
    assert not _use_compact(AggConfig(kind="sia", q=9), D, chain, False,
                            "auto")
    assert not _use_compact(AggConfig(kind="cl_sia", q=9,
                                      topq_impl="threshold"), D, chain,
                            False, "auto")
    assert not _use_compact(cfg, D, tree, False, "dense")
    with pytest.raises(ValueError, match="constant-length"):
        _use_compact(AggConfig(kind="sia", q=9), D, chain, False, "compact")
    with pytest.raises(ValueError, match="unknown wire"):
        _use_compact(cfg, D, chain, False, "sparse")


@pytest.mark.parametrize("kind", ["sia", "cl_sia", "cl_tc_sia", "dense_ia"])
def test_bf16_gradients_stay_bit_exact(kind):
    """The inbox lives in the gradients' dtype and takes a float32 γ per
    slot, as the host executor's does."""
    cfg, jcfg = _cfgs(kind)
    plan, jplan = _plans()["routed"]
    g, e = _inputs(19)
    g16, e16 = _t(g).bfloat16(), _t(e).bfloat16()
    gm = _t(_gmask(cfg)).bfloat16()
    w = torch.ones(K)
    host = execute(cfg, plan, g16, e16, w, global_mask=gm)
    for wire in ("auto", "dense"):
        got = execute_sharded(cfg, plan, g16, e16, w, mesh=MESH,
                              global_mask=gm, wire=wire)
        assert got.aggregate.dtype == torch.bfloat16
        _assert_round(host, got, None, f"bf16 {kind}/{wire}")


def test_bf16_compact_wire_quantizes_within_tolerance():
    """ω = 16: values travel as bfloat16, indices exactly — the aggregate
    within 2e-2 relative of the float32 wire with the same support, and
    half the ω bits. ``wire="auto"`` never quantizes."""
    plan = _plans()["routed"][0]
    g, e = _inputs(23, d=257)
    zero = torch.zeros((K, 257))

    def run(wire_dtype, wire):
        cfg = AggConfig(kind="cl_sia", q=5, wire_dtype=wire_dtype,
                        omega=32 if wire_dtype == "float32" else 16)
        return execute_sharded(cfg, plan, _t(g), zero, torch.ones(K),
                               mesh=MESH, wire=wire)

    exact, quant = run("float32", "compact"), run("bfloat16", "compact")
    a, b = exact.aggregate.numpy(), quant.aggregate.numpy()
    rel = np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-3))
    assert 0 < rel < 2e-2, rel
    np.testing.assert_array_equal(a != 0, b != 0)
    assert float(quant.stats.bits.sum()) < 0.7 * float(exact.stats.bits.sum())
    host = execute(AggConfig(kind="cl_sia", q=5, wire_dtype="bfloat16",
                             omega=16), plan, _t(g), zero, torch.ones(K))
    _assert_round(host, run("bfloat16", "auto"), None, "auto")


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

def test_client_mesh_takes_explicit_device_lists():
    mesh = client_mesh(4, devices=["cpu"] * 4)
    assert mesh.size == 4 and mesh.distinct() == (torch.device("cpu"),)
    assert ClientMesh(devices=("cpu", torch.device("cpu"))).size == 2
    with pytest.raises(ValueError, match="2 devices"):
        client_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="at least one"):
        ClientMesh(devices=())
    cfg = AggConfig(kind="cl_sia", q=9)
    g, e = _inputs()
    with pytest.raises(ValueError, match="mesh has 4 ranks"):
        execute_sharded(cfg, compile_plan(K), _t(g), _t(e), torch.ones(K),
                        mesh=mesh)
    with pytest.raises(ValueError, match="plan has 8 clients"):
        execute_sharded(cfg, compile_plan(K), _t(g[:4]), _t(e[:4]),
                        torch.ones(4), mesh=mesh)


def test_results_return_on_the_callers_device():
    cfg = AggConfig(kind="tc_sia", q=9)
    g, e = _inputs()
    got = execute_sharded(cfg, _plans()["hand"][0], _t(g), _t(e),
                          torch.ones(K), mesh=MESH,
                          global_mask=_t(_gmask(cfg)))
    assert got.aggregate.shape == (D,) and got.e_new.shape == (K, D)
    assert all(s.shape == (K,) for s in got.stats)
    assert got.stats.nnz_out.dtype == torch.int32
    assert got.stats.bits.dtype == torch.float32
    assert {t.device.type for t in (got.aggregate, got.e_new, *got.stats)
            } == {"cpu"}


# ---------------------------------------------------------------------------
# Whole runs: Simulator(backend="device") = backend="host"
# ---------------------------------------------------------------------------

SIM_K = 8


@functools.lru_cache(maxsize=None)
def _fed():
    train = make_synthetic_mnist(0, SIM_K * 60, device="cpu")
    return partition_iid(train, SIM_K, torch.Generator().manual_seed(2))


def _sim_pair(cfg, **kw):
    pc = dataclasses.replace(PAPER, num_clients=SIM_K)
    host = Simulator(pc, cfg, _fed(), device="cpu", **kw)
    dev = Simulator(pc, cfg, _fed(), device="cpu", backend="device",
                    mesh=client_mesh(SIM_K, devices=["cpu"] * SIM_K), **kw)
    return host, dev


def _same_runs(a, b):
    assert a["loss"] == b["loss"] and a["bits"] == b["bits"]
    assert a["nnz"] == b["nnz"]
    for x, y in zip(a["state"], b["state"]):
        if isinstance(x, torch.Tensor):
            _same(x, y)
        elif isinstance(x, tuple):
            for u, v in zip(x, y):
                _same(u, v)


@pytest.mark.parametrize("kind", ["cl_sia", "tc_sia", "cl_tc_sia"])
def test_device_backend_runs_equal_host_runs_on_the_chain(kind):
    host, dev = _sim_pair(AggConfig(kind=kind, q=78))

    def stragglers(r, state):
        p = np.ones((SIM_K,), np.float32)
        p[(r + 1) % SIM_K] = 0.0
        return p

    runs = [sim.run(5, seed=3, participate_fn=stragglers)
            for sim in (host, dev)]
    _same_runs(*runs)
    assert dev.trace_counter.count == 1


@pytest.mark.parametrize("kind", ["sia", "cl_tc_sia"])
def test_device_backend_runs_equal_host_runs_on_a_failing_tree(kind):
    topo = TreeTopology(tg.walker_delta(2, 4, gateways=(1, 4)),
                        routing="widest")
    fails = FailureSchedule(SIM_K, {1: ([0], []), 3: ([], [0])})
    host, dev = _sim_pair(AggConfig(kind=kind, q=78), tree_topology=topo)
    runs = [sim.run(5, seed=4, failure_schedule=fails)
            for sim in (host, dev)]
    _same_runs(*runs)


def test_device_backend_refuses_a_bad_backend_or_mesh():
    pc = dataclasses.replace(PAPER, num_clients=SIM_K)
    cfg = AggConfig(kind="cl_sia", q=78)
    with pytest.raises(ValueError, match="unknown backend"):
        Simulator(pc, cfg, _fed(), device="cpu", backend="ring")
    with pytest.raises(ValueError, match="mesh has 4 ranks"):
        Simulator(pc, cfg, _fed(), device="cpu", backend="device",
                  mesh=client_mesh(4, devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="only with backend='device'"):
        Simulator(pc, cfg, _fed(), device="cpu", mesh=MESH)
