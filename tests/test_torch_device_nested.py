"""Nested (staged) plans on the port's client mesh
(``repro_torch.agg.device.execute_nested_sharded``), and the device
backend's whole runs: nested simulator rounds, a scenario trace and the
``obs.smoke`` run.

* ``execute_nested_sharded`` against jitted ``repro.agg.execute_nested``
  on the reference's own cases (``tests/test_nested_device.py``,
  ``CLIENTS_NESTED_EQUIV``): the six kinds over the chain×chain stack
  ``pod_ring_nested(2, 4)`` and a tree×chain stack, padded to one shape,
  with stragglers and a stage EF tier — the aggregate, the client EF, the
  stage EF tier and every stage's ``nnz_*`` and ``bits`` bit for bit,
  ``err_sq`` to rtol 1e-6; against the port's host ``execute_nested`` bit
  for bit, ``err_sq`` included, also on a routed cluster plan, under
  threshold Top-Q and with a forest upper stage.
* ``_pad_plan_clients`` gives the reference's padded stage plan.
* ``Simulator(backend="device")`` with a nested topology equals the host
  backend bit for bit over five rounds (model, EF, stage EF tier, bits,
  loss); a scenario run on the device backend writes a trace equal to the
  host run's round for round; ``obs.smoke --device`` passes on the CPU.

Sizes: K = 8 clients, d = 97 (the reference's own test).
"""

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

from repro.agg import nested as jn
from repro.agg.device import _pad_plan_clients as j_pad_plan_clients
from repro.core.algorithms import AggConfig as JCfg
from repro.topo.tree import PS as JPS
from repro.topo.tree import AggTree as JTree
from repro_torch.agg import nested as tn
from repro_torch.agg.device import (_pad_plan_clients, client_mesh,
                                    execute_nested_sharded)
from repro_torch.agg.nested import (compile_nested, execute_nested,
                                    nested_common_shape, pod_ring_nested)
from repro_torch.agg.schedule import TopologySchedule
from repro_torch.configs import PAPER
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.data import make_synthetic_mnist, partition_iid
from repro_torch.fed import Simulator
from repro_torch.topo import graph as tg
from repro_torch.topo.routing import cluster_routed
from repro_torch.topo.tree import PS, AggTree

torch.set_num_threads(1)

K, D = 8, 97
KINDS = ["sia", "re_sia", "cl_sia", "tc_sia", "cl_tc_sia", "dense_ia"]
PART = np.asarray([1, 0, 1, 1, 1, 0, 1, 1], np.float32)
ERR_RTOL = 1e-6
MESH = client_mesh(K, devices=["cpu"] * K)


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((K, D)).astype(np.float32),
            (0.1 * r.standard_normal((K, D))).astype(np.float32),
            (0.2 * r.standard_normal((2, D))).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gmask(cfg):
    gm = np.zeros((D,), np.float32)
    if cfg.kind in (AggKind.TC_SIA, AggKind.CL_TC_SIA):
        gm[:cfg.q_global] = 1.0
    return gm


def _treex(lib, tree_cls, ps):
    intra = tree_cls(parent=(ps, 0, 0, 1))
    return lib.compile_nested([[(tuple(range(4)), intra),
                                (tuple(range(4, 8)), None)],
                               [((0, 1), None)]])


@functools.lru_cache(maxsize=None)
def _plans():
    """name → (port nested plan, reference nested plan), the two stacks
    padded to one shape as the reference's test pads them."""
    port = {"chainxchain": pod_ring_nested(2, 4),
            "treexchain": _treex(tn, AggTree, PS)}
    ref = {"chainxchain": jn.pod_ring_nested(2, 4),
           "treexchain": _treex(jn, JTree, JPS)}
    shape = nested_common_shape(list(port.values()))
    return {n: (port[n].pad(shape), ref[n].pad(shape)) for n in port}


@functools.partial(jax.jit, static_argnums=0)
def _jexecute_nested(cfg, nested, g, e, w, se, gm, part):
    return jn.execute_nested(cfg, nested, g, e, w, stage_e=se,
                             global_mask=gm, participate=part)


def _same(a, b, msg=""):
    a = a.view(torch.int16) if isinstance(a, torch.Tensor) and \
        a.dtype == torch.bfloat16 else a
    b = b.view(torch.int16) if isinstance(b, torch.Tensor) and \
        b.dtype == torch.bfloat16 else b
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (msg, a.shape, b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _assert_stats(want, got, err_rtol, msg):
    for f in ("nnz_out", "nnz_global", "nnz_local", "bits"):
        _same(getattr(want, f), getattr(got, f), f"{msg} {f}")
    if err_rtol is None:
        _same(want.err_sq, got.err_sq, f"{msg} err_sq")
    else:
        np.testing.assert_allclose(np.asarray(want.err_sq),
                                   got.err_sq.numpy(), rtol=err_rtol,
                                   atol=1e-6, err_msg=msg)


def _assert_nested(want, got, err_rtol=None, msg=""):
    _same(want.aggregate, got.aggregate, msg + " aggregate")
    _same(want.e_new, got.e_new, msg + " e_new")
    assert len(want.stage_e_new) == len(got.stage_e_new)
    for a, b in zip(want.stage_e_new, got.stage_e_new):
        _same(a, b, msg + " stage EF")
    _assert_stats(want.stats, got.stats, err_rtol, msg + " stage 0")
    for s, (a, b) in enumerate(zip(want.stage_stats, got.stage_stats)):
        _assert_stats(a, b, err_rtol, f"{msg} stage {s + 1}")


@pytest.mark.parametrize("name", ["chainxchain", "treexchain"])
@pytest.mark.parametrize("kind", KINDS)
def test_execute_nested_sharded_matches_reference(kind, name):
    kw = dict(kind=kind, q=9)
    cfg, jcfg = AggConfig(**kw), JCfg(kernel_mode="ref", **kw)
    plan, jplan = _plans()[name]
    g, e, se = _inputs()
    w = np.ones((K,), np.float32)
    gm = _gmask(cfg)
    want = _jexecute_nested(jcfg, jplan, g, e, w, (se,), gm, PART)
    opt = dict(stage_e=(_t(se),), global_mask=_t(gm), participate=_t(PART))
    host = execute_nested(cfg, plan, _t(g), _t(e), _t(w), **opt)
    got = execute_nested_sharded(cfg, plan, _t(g), _t(e), _t(w), mesh=MESH,
                                 **opt)
    _assert_nested(want, got, ERR_RTOL, f"{kind}/{name} vs reference")
    _assert_nested(host, got, None, f"{kind}/{name} vs host")


def _routed_clusters():
    return compile_nested(cluster_routed(tg.grid_graph(2, 4), 2))


def _three_stages():
    """Four pods of two; the pod heads pair up (a forest upper stage of
    two sinks); the pair heads reach the PS."""
    return compile_nested([[((0, 1), None), ((2, 3), None), ((4, 5), None),
                            ((6, 7), None)],
                           [((0, 1), None), ((2, 3), None)],
                           [((0, 1), None)]])


@pytest.mark.parametrize("impl", ["exact", "scan", "hist"])
@pytest.mark.parametrize("plan_name", ["routed", "three_stages"])
@pytest.mark.parametrize("kind", ["sia", "cl_sia", "tc_sia", "cl_tc_sia"])
def test_execute_nested_sharded_equals_host(kind, plan_name, impl):
    kw = {"exact": {},
          "scan": dict(topq_impl="threshold", tau_impl="scan",
                       hist_rounds=3),
          "hist": dict(topq_impl="threshold", tau_impl="hist",
                       hist_rounds=2)}[impl]
    cfg = AggConfig(kind=kind, q=9, **kw)
    plan = (_routed_clusters() if plan_name == "routed"
            else _three_stages())
    g, e, _ = _inputs(3)
    rng = np.random.default_rng(4)
    se = tuple(_t((0.2 * rng.standard_normal((u, D))).astype(np.float32))
               for u in plan.stage_units[1:])
    opt = dict(stage_e=se, global_mask=_t(_gmask(cfg)),
               participate=_t(PART))
    host = execute_nested(cfg, plan, _t(g), _t(e), torch.ones(K), **opt)
    got = execute_nested_sharded(cfg, plan, _t(g), _t(e), torch.ones(K),
                                 mesh=MESH, **opt)
    _assert_nested(host, got, None, f"{kind}/{plan_name}/{impl}")


def test_nested_bf16_and_default_tiers_equal_host():
    cfg = AggConfig(kind="cl_tc_sia", q=9)
    plan = _three_stages()
    g, e, _ = _inputs(5)
    g16, e16 = _t(g).bfloat16(), _t(e).bfloat16()
    gm = _t(_gmask(cfg)).bfloat16()
    host = execute_nested(cfg, plan, g16, e16, torch.ones(K),
                          global_mask=gm)
    got = execute_nested_sharded(cfg, plan, g16, e16, torch.ones(K),
                                 mesh=MESH, global_mask=gm)
    assert [t.dtype for t in got.stage_e_new] == [t.dtype for t in
                                                  host.stage_e_new]
    _assert_nested(host, got, None, "bf16")


def test_pad_plan_clients_matches_reference():
    for name, (plan, jplan) in _plans().items():
        up, jup = plan.stages[1], jplan.stages[1]
        got = _pad_plan_clients(up, K)
        want = j_pad_plan_clients(jup, K)
        for f in ("node_id", "slot_mask", "parent_row", "flat_pos",
                  "alive"):
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f"{name} {f}")
        assert (got.num_clients, got.num_sinks) == (K, up.num_sinks)
    assert _pad_plan_clients(plan.stages[0], K) is plan.stages[0]
    with pytest.raises(ValueError, match="shrink"):
        _pad_plan_clients(plan.stages[0], 4)
    with pytest.raises(TypeError, match="NestedPlan"):
        execute_nested_sharded(AggConfig(), plan.stages[0],
                               torch.zeros((K, D)), torch.zeros((K, D)),
                               torch.ones(K), mesh=MESH)


# ---------------------------------------------------------------------------
# Whole runs on the device backend
# ---------------------------------------------------------------------------

SIM_K = 8


@functools.lru_cache(maxsize=None)
def _fed():
    train = make_synthetic_mnist(0, SIM_K * 60, device="cpu")
    return partition_iid(train, SIM_K, torch.Generator().manual_seed(2))


def _cpu_mesh():
    return client_mesh(SIM_K, devices=["cpu"] * SIM_K)


@pytest.mark.parametrize("topo", ["pod_ring", "schedule"])
@pytest.mark.parametrize("kind", ["cl_sia", "tc_sia"])
def test_nested_simulator_device_equals_host(kind, topo):
    pc = dataclasses.replace(PAPER, num_clients=SIM_K)
    cfg = AggConfig(kind=kind, q=78)
    kw, run_kw = {}, {}
    if topo == "pod_ring":
        kw = dict(nested_topology=pod_ring_nested(2, 4))
    else:
        plans = [pod_ring_nested(2, 4), _routed_clusters()]
        run_kw = dict(topology_schedule=TopologySchedule.from_topologies(
            plans, round_index=[0, 1, 1, 0, 1]))
    host = Simulator(pc, cfg, _fed(), device="cpu", **kw)
    dev = Simulator(pc, cfg, _fed(), device="cpu", backend="device",
                    mesh=_cpu_mesh(), **kw)
    a, b = (sim.run(5, seed=5, **run_kw) for sim in (host, dev))
    assert a["loss"] == b["loss"] and a["bits"] == b["bits"]
    _same(a["state"].flat_w, b["state"].flat_w)
    _same(a["state"].ef, b["state"].ef)
    assert len(b["state"].stage_ef) == 1
    _same(a["state"].stage_ef[0], b["state"].stage_ef[0])
    assert dev.trace_counter.count == host.trace_counter.count == 1


def _rounds(path):
    """The trace's round records without their host-clock phases."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    out = []
    for r in recs:
        if r["kind"] == "round":
            r.pop("phases", None)
            out.append(r)
    return recs[0], out


def test_device_scenario_trace_equals_the_host_trace(tmp_path):
    from repro_torch.obs import validate_trace
    from repro_torch.scenario import Crash, Scenario, TopologySpec
    from repro_torch.scenario.run import run_scenario

    spec = Scenario(name="device-clusters", rounds=6, seed=3,
                    topology=TopologySpec(kind="grid", clients=SIM_K,
                                          clusters=2,
                                          params={"rows": 2, "cols": 4}),
                    crashes=(Crash(node=1, round=2, recover=4),))
    paths = [str(tmp_path / f"{b}.jsonl") for b in ("host", "device")]
    host = run_scenario(spec, out=paths[0], device="cpu")
    dev = run_scenario(spec, backend="device", out=paths[1], device="cpu",
                       mesh="cpu")
    assert host["_retraces"] == dev["_retraces"] == 1
    assert host["loss"] == dev["loss"] and host["bits"] == dev["bits"]
    (hmeta, hrec), (dmeta, drec) = _rounds(paths[0]), _rounds(paths[1])
    assert (hmeta["backend"], dmeta["backend"]) == ("host", "device")
    assert len(drec) == spec.rounds and drec == hrec
    assert not validate_trace(paths[1])["errors"]


def test_obs_smoke_runs_the_device_backend_on_the_cpu(tmp_path, capsys):
    from repro_torch.obs import smoke
    assert smoke.main(["--device", "--mesh", "cpu", "--torch-device", "cpu",
                       "--rounds", "3", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for name in ("device_chain", "device_nested"):
        assert f"[OK] {name}" in out
        meta = json.loads(open(tmp_path / f"{name}.jsonl").readline())
        assert meta["backend"] == "device"
