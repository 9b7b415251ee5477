"""The port's scenario engine against the JAX package's, and the cases of
``tests/test_scenario.py`` on the port.

* Specs: the port's presets are the reference's (same dicts, same JSON);
  a spec file written by either package loads in the other.
* Compiler: every plan of a compiled scenario — chain, routed graph with
  link flaps, bandwidth ramps with budgets, clustered (nested) — equals
  the reference's, and so do the participation matrices of crash and
  deadline windows and the realized event streams. Straggler masks are
  drawn from a ``torch.Generator`` (the reference draws with
  ``jax.random``), so they are checked for determinism and their windows;
  runs compared with the reference are fed its participation matrix.
* Replay: run twice and replay from the trace are bit-identical, one input
  signature; the CLI runs and replays; injected events reach the trace, the
  report and the Chrome export.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro.scenario as jsc
from repro.configs import PAPER as JPAPER
from repro.core.algorithms import AggConfig as JCfg
from repro.data.federated import partition_iid as jpartition
from repro.data.synthetic import make_synthetic_mnist as jmnist
from repro.fed import simulator as jsim
from repro.obs import TraceCollector as JCollector
from repro.obs.report import diff as jdiff
from repro_torch.configs import PAPER
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.data import FederatedData
from repro_torch.fed.simulator import Simulator
from repro_torch.obs import TraceCollector
from repro_torch.scenario import (PRESETS, BandwidthRamp, CompiledScenario,
                                  Crash, DeadlineWindow, LinkFlap, Scenario,
                                  StragglerWindow, TopologySpec,
                                  compile_scenario, preset,
                                  scenario_from_trace)
from repro_torch.scenario.compile import straggler_generator

torch.set_num_threads(1)


def _assert_plan_equal(jp, tp):
    stages = getattr(tp, "stages", None)
    if stages is not None:
        assert tp.shape == jp.shape
        for a, b in zip(jp.stages, tp.stages):
            _assert_plan_equal(a, b)
        np.testing.assert_array_equal(tp.client_alive(),
                                      np.asarray(jp.client_alive()))
        return
    for f in ("node_id", "slot_mask", "parent_row", "flat_pos", "alive"):
        np.testing.assert_array_equal(getattr(tp, f),
                                      np.asarray(getattr(jp, f)))
    assert (tp.q_budget is None) == (jp.q_budget is None)
    if tp.q_budget is not None:
        np.testing.assert_array_equal(tp.q_budget, np.asarray(jp.q_budget))


def _assert_compiled_equal(jc, tc, participation=True):
    assert tc.rounds == jc.rounds and tc.num_clients == jc.num_clients
    assert tc.schedule.round_index == jc.schedule.round_index
    assert len(tc.schedule.plans) == len(jc.schedule.plans)
    for r in range(tc.rounds):
        _assert_plan_equal(jc.schedule.plan_at(r), tc.schedule.plan_at(r))
    assert tc.events == jc.events
    if participation:
        np.testing.assert_array_equal(tc.participation,
                                      np.asarray(jc.participation))


def _walker_spec(name="clustered-walker", rounds=10):
    return Scenario(
        name=name, rounds=rounds, seed=4,
        topology=TopologySpec(kind="walker_delta", clients=8,
                              params={"num_planes": 2, "sats_per_plane": 4,
                                      "gateways": [1, 5]},
                              clusters=2),
        crashes=(Crash(node=2, round=3, recover=6),),
        link_flaps=(LinkFlap(link=(1, 5), start=2, down=2, period=5),))


# ---------------------------------------------------------------------------
# Spec schema
# ---------------------------------------------------------------------------

def test_spec_json_roundtrip_presets():
    assert sorted(PRESETS) == sorted(jsc.PRESETS)
    for name in PRESETS:
        s = preset(name)
        s2 = Scenario.from_dict(json.loads(json.dumps(s.to_dict())))
        assert s2 == s
        assert s.to_dict() == jsc.preset(name).to_dict()
        assert s.to_json() == jsc.preset(name).to_json()


def test_spec_roundtrip_all_fault_types(tmp_path):
    kw = dict(
        name="everything", rounds=12, seed=5, agg={"kind": "cl_sia", "q": 10},
        bandwidth_aware=True)
    faults = lambda lib: dict(  # noqa: E731
        topology=lib.TopologySpec(kind="grid", clients=8,
                                  params={"rows": 2, "cols": 4},
                                  routing="widest"),
        link_flaps=(lib.LinkFlap(link=(2, 3), start=1, down=2, period=6),),
        crashes=(lib.Crash(node=1, round=3, recover=7),),
        stragglers=(lib.StragglerWindow(p_straggle=0.3, start=2, end=9,
                                        correlated=True, seed=4),),
        ramps=(lib.BandwidthRamp(start=2, end=8, floor=0.25, recover=10,
                                 links=((0, 1),)),),
        deadlines=(lib.DeadlineWindow(deadline_s=1.5, start=4, end=8,
                                      seed=2),))
    import repro_torch.scenario as tsc
    s = Scenario(**kw, **faults(tsc))
    path = tmp_path / "spec.json"
    s.to_json(str(path))
    s2 = Scenario.from_json(str(path))
    assert s2 == s
    assert s2.agg_config().q == 10
    assert s2.agg_config().kind == AggKind.CL_SIA
    # the reference reads the port's file and writes the same one back
    j = jsc.Scenario.from_json(str(path))
    assert j == jsc.Scenario(**kw, **faults(jsc))
    assert j.to_json() == s.to_json()


def test_spec_validation():
    chain = TopologySpec(kind="chain", clients=4)
    with pytest.raises(ValueError, match="link"):
        Scenario(name="x", rounds=4, topology=chain,
                 link_flaps=(LinkFlap(link=(1, 2)),))
    with pytest.raises(ValueError, match="routing"):
        TopologySpec(kind="grid", routing="fastest")
    with pytest.raises(ValueError, match="recover"):
        Crash(node=0, round=5, recover=5)
    with pytest.raises(ValueError, match="window"):
        BandwidthRamp(start=4, end=4)
    with pytest.raises(ValueError, match="period"):
        LinkFlap(link=(0, 1), down=4, period=2)
    with pytest.raises(ValueError, match="preset"):
        preset("no-such-preset")
    with pytest.raises(ValueError, match="schema"):
        Scenario.from_dict({"schema": "other/1", "name": "x", "rounds": 1,
                            "topology": {}})


def test_fault_timelines():
    fl = LinkFlap(link=(3, 1), start=2, down=2, period=5)
    assert fl.link == (1, 3)
    assert [r for r in range(12) if fl.is_down(r)] == [2, 3, 7, 8]
    one = LinkFlap(link=(0, 1), start=4, down=3)
    assert [r for r in range(10) if one.is_down(r)] == [4, 5, 6]
    rp = BandwidthRamp(start=2, end=6, floor=0.2, recover=8)
    assert rp.factor(0) == 1.0 and rp.factor(2) == 1.0
    assert rp.factor(4) == 0.6
    assert rp.factor(6) == 0.2 and rp.factor(7) == 0.2
    assert rp.factor(8) == 1.0
    cr = Crash(node=2, round=3, recover=6)
    assert [r for r in range(8) if cr.is_dead(r)] == [3, 4, 5]


def test_topology_spec_builds_the_reference_graphs():
    for name in PRESETS:
        ts, js = preset(name).topology, jsc.preset(name).topology
        assert ts.num_clients == js.num_clients
        tg_, jg_ = ts.build(), js.build()
        np.testing.assert_array_equal(np.asarray(tg_.edges),
                                      np.asarray(jg_.edges))
        np.testing.assert_array_equal(np.asarray(tg_.client_nodes()),
                                      np.asarray(jg_.client_nodes()))


# ---------------------------------------------------------------------------
# Compiler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["relay-cascade", "orbital-eclipse",
                                  "uplink-degradation"])
def test_compiled_presets_match_reference(name):
    _assert_compiled_equal(jsc.compile_scenario(jsc.preset(name)),
                           compile_scenario(preset(name)))


def test_compiled_clustered_scenario_matches_reference():
    spec = _walker_spec()
    jspec = jsc.Scenario.from_dict(spec.to_dict())
    tc = compile_scenario(spec)
    _assert_compiled_equal(jsc.compile_scenario(jspec), tc)
    assert all(hasattr(p, "stages") for p in tc.schedule.plans)
    assert len({p.shape for p in tc.schedule.plans}) == 1


def test_deadline_participation_matches_reference():
    spec = Scenario(name="deadlines", rounds=9,
                    topology=TopologySpec(kind="chain", clients=6),
                    deadlines=(DeadlineWindow(deadline_s=1.2, start=2,
                                              end=7, seed=3),),
                    crashes=(Crash(node=4, round=1, recover=3),))
    jspec = jsc.Scenario.from_dict(spec.to_dict())
    _assert_compiled_equal(jsc.compile_scenario(jspec),
                           compile_scenario(spec))


def test_compile_relay_cascade_lowering():
    c = compile_scenario(preset("relay-cascade"))
    s = c.spec
    assert isinstance(c, CompiledScenario)
    assert c.rounds == s.rounds and c.num_clients == 8
    dead_sets = {frozenset(cr.node for cr in s.crashes if cr.is_dead(r))
                 for r in range(s.rounds)}
    assert len(c.schedule.plans) == len(dead_sets) < s.rounds
    assert len({p.shape for p in c.schedule.plans}) == 1
    for r in range(s.rounds):
        plan = c.schedule.plan_at(r)
        for cr in s.crashes:
            if cr.is_dead(r):
                assert c.participation[r, cr.node] == 0.0
                assert plan.alive[cr.node] == 0.0
            else:
                assert plan.alive[cr.node] == 1.0
    assert sorted(ev["kind"] for ev in c.events) == ["crash"] * 3
    by_node = {ev["args"]["node"]: ev for ev in c.events}
    assert by_node[2]["round"] == 8 and by_node[2]["rounds"] == 8
    assert by_node[5]["rounds"] == s.rounds - 4


def test_compile_flaps_share_plans_cyclically():
    c = compile_scenario(preset("orbital-eclipse"))
    assert len(c.schedule.plans) < c.rounds
    assert len(c.schedule.round_index) == c.rounds
    assert all(p.q_budget is None for p in c.schedule.plans)
    assert len({p.shape for p in c.schedule.plans}) == 1


def test_compile_bandwidth_aware_budgets_follow_ramp():
    c = compile_scenario(preset("uplink-degradation"))
    assert all(p.q_budget is not None for p in c.schedule.plans)
    before = c.schedule.plan_at(0).q_budget
    floored = c.schedule.plan_at(13).q_budget
    assert int(floored.sum()) < int(before.sum())
    after = c.schedule.plan_at(17).q_budget
    assert int(after.sum()) > int(floored.sum())


def test_compile_is_deterministic():
    a = compile_scenario(preset("straggler-storm"))
    b = compile_scenario(preset("straggler-storm"))
    np.testing.assert_array_equal(a.participation, b.participation)
    assert a.events == b.events
    assert a.events == jsc.compile_scenario(
        jsc.preset("straggler-storm")).events
    s = a.spec
    active = [any(w.active(r) for w in s.stragglers)
              or any(d.active(r) for d in s.deadlines)
              for r in range(s.rounds)]
    for r in range(s.rounds):
        if not active[r]:
            np.testing.assert_array_equal(a.participation[r], 1.0)
    assert a.participation.min() == 0.0


def test_straggler_draws_come_from_the_window_seed_and_round():
    """Each active round's mask is the StragglerModel drawn from the
    window's (seed, round) generator, correlated with the previous active
    round and never across a gap."""
    sw = StragglerWindow(p_straggle=0.4, start=2, end=7, correlated=True,
                         seed=11)
    spec = Scenario(name="s", rounds=9, stragglers=(sw,),
                    topology=TopologySpec(kind="chain", clients=32))
    part = compile_scenario(spec).participation
    model, prev = sw.model(), None
    for r in range(9):
        if not sw.active(r):
            np.testing.assert_array_equal(part[r], 1.0)
            continue
        prev = model.sample(straggler_generator(sw.seed, r), 32, prev)
        np.testing.assert_array_equal(part[r], prev.numpy())
    assert 0.2 < 1.0 - part[2:7].mean() < 0.8


def test_compile_rejects_bad_combinations():
    with pytest.raises(ValueError, match="bandwidth_aware"):
        compile_scenario(Scenario(
            name="x", rounds=2, bandwidth_aware=True,
            topology=TopologySpec(kind="chain", clients=4)))
    with pytest.raises(ValueError, match="widest"):
        compile_scenario(Scenario(
            name="x", rounds=2,
            topology=TopologySpec(kind="grid", clients=8,
                                  params={"rows": 2, "cols": 4},
                                  routing="widest", clusters=2)))


# ---------------------------------------------------------------------------
# Runs: replay, the reference's participation, exclusivity
# ---------------------------------------------------------------------------

def _small_spec():
    return Scenario(
        name="small-cascade", rounds=8, seed=1,
        topology=TopologySpec(kind="chain", clients=5),
        crashes=(Crash(node=2, round=2, recover=6),),
        stragglers=(StragglerWindow(p_straggle=0.35, start=3, end=7,
                                    correlated=True, seed=9),))


def test_run_twice_and_replay_from_trace_bit_identical(tmp_path):
    from repro_torch.obs import validate_trace
    from repro_torch.scenario.run import run_scenario

    t1, t2, t3 = (str(tmp_path / f"t{i}.jsonl") for i in (1, 2, 3))
    a = run_scenario(_small_spec(), out=t1, device="cpu")
    b = run_scenario(_small_spec(), out=t2, device="cpu")
    assert a["_retraces"] == 1 and b["_retraces"] == 1
    assert a["loss"] == b["loss"]
    assert a["bits"] == b["bits"]
    spec2, meta = scenario_from_trace(t1)
    assert spec2 == _small_spec()
    assert meta["topology"] == "scenario"
    c = run_scenario(spec2, out=t3, device="cpu")
    assert c["loss"] == a["loss"] and c["bits"] == a["bits"]
    assert validate_trace(t1)["errors"] == []
    # the reference reads the spec out of the port's trace
    assert jsc.scenario_from_trace(t1)[0] == jsc.Scenario.from_dict(
        _small_spec().to_dict())


@pytest.mark.parametrize("spec_of", [_small_spec, _walker_spec],
                         ids=["chain-stragglers", "clustered-walker"])
def test_scenario_run_with_reference_participation_gives_its_bits(
        spec_of, tmp_path):
    """The reference's compiled scenario and the port's, with the
    reference's participation matrix fed in: CL-SIA's bits and counts per
    round (data-independent on dense inputs) are equal and the two traces
    diff to zero bits."""
    spec = spec_of()
    k = spec.num_clients
    jspec = jsc.Scenario.from_dict(spec.to_dict())
    jpc = dataclasses.replace(JPAPER, num_clients=k)
    pc = dataclasses.replace(PAPER, num_clients=k)
    jfed = jpartition(jax.random.PRNGKey(2),
                      jmnist(jax.random.PRNGKey(0), k * 40), k)
    jcomp = jsc.compile_scenario(jspec)
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    with JCollector(jpath) as col:
        want = jsim.Simulator(jpc, JCfg(kind="cl_sia", q=jpc.q), jfed).run(
            spec.rounds, scenario=jcomp, collector=col)
    comp = dataclasses.replace(
        compile_scenario(spec),
        participation=np.asarray(jcomp.participation, np.float32))
    fed = FederatedData(x=torch.from_numpy(np.array(jfed.x)),
                        y=torch.from_numpy(np.array(jfed.y)).long())
    sim = Simulator(pc, AggConfig(kind="cl_sia", q=pc.q), fed,
                    device="cpu")
    with TraceCollector(tpath) as col:
        got = sim.run(spec.rounds, scenario=comp, collector=col)
    assert got["bits"] == want["bits"]
    assert got["nnz"] == want["nnz"]
    d = jdiff(jpath, tpath)
    assert d["rounds_bits_differ"] == [] and d["bits_total_delta"] == 0.0
    # the minibatches are each package's own draws: the losses differ,
    # and fall in both
    assert got["loss"][-1] < got["loss"][0] and \
        want["loss"][-1] < want["loss"][0]


def _port_sim(k, **kw):
    from repro_torch.data import make_synthetic_mnist, partition_iid
    pc = dataclasses.replace(PAPER, num_clients=k)
    fed = partition_iid(make_synthetic_mnist(0, k * 20, device="cpu"), k,
                        torch.Generator().manual_seed(2))
    return Simulator(pc, AggConfig(kind=AggKind.CL_SIA, q=pc.q), fed,
                     device="cpu", **kw)


def test_simulator_scenario_exclusivity():
    sim = _port_sim(5)
    spec = _small_spec()
    with pytest.raises(ValueError, match="alone"):
        sim.run(2, scenario=spec, participate_fn=lambda r, s: None)
    with pytest.raises(ValueError, match="alone"):
        sim.run(2, scenario=spec, topology=5)
    wrong_k = Scenario(name="x", rounds=2,
                       topology=TopologySpec(kind="chain", clients=3))
    with pytest.raises(ValueError, match="clients"):
        sim.run(2, scenario=wrong_k)


# ---------------------------------------------------------------------------
# Injected-event telemetry and the CLI
# ---------------------------------------------------------------------------

def test_injected_events_in_trace_report_and_chrome(tmp_path):
    from repro_torch.obs import iter_trace
    from repro_torch.obs.chrome import FAULT_PID, export_chrome_trace
    from repro_torch.obs.report import summarize
    from repro_torch.scenario.run import run_scenario

    path = str(tmp_path / "trace.jsonl")
    run_scenario(_small_spec(), out=path, device="cpu")
    spans = [r for r in iter_trace(path)
             if r["kind"] == "span" and r["track"] == "scenario"]
    assert len(spans) == 2
    meta = next(r for r in iter_trace(path) if r["kind"] == "meta")
    assert meta["scenario_spec"]["name"] == "small-cascade"
    out = summarize(path)
    assert {ev["kind"] for ev in out["injected"]} == {"crash", "stragglers"}
    crash = next(ev for ev in out["injected"] if ev["kind"] == "crash")
    assert crash["round"] == 2 and crash["rounds"] == 4
    assert "crash client 2" not in out.get("phases_s", {})
    assert "scenario_spec" not in out["context"]
    events = json.load(open(export_chrome_trace(path)))["traceEvents"]
    faults = [e for e in events if e.get("cat") == "fault"]
    assert len(faults) == 2
    assert all(e["pid"] == FAULT_PID for e in faults)
    hop_ts = [e["ts"] for e in events if e.get("cat") == "hop"]
    for e in faults:
        assert min(hop_ts) <= e["ts"] <= max(hop_ts)


def test_cli_run_and_replay(tmp_path, capsys):
    from repro_torch.obs.report import diff
    from repro_torch.scenario.run import main

    spec_path = str(tmp_path / "spec.json")
    _small_spec().to_json(spec_path)
    t1 = str(tmp_path / "a.jsonl")
    t2 = str(tmp_path / "b.jsonl")
    cpu = ["--torch-device", "cpu"]
    assert main([spec_path, "--out", t1] + cpu) == 0
    assert main([t1, "--out", t2] + cpu) == 0
    assert "[OK] small-cascade" in capsys.readouterr().out
    d = diff(t1, t2)
    assert d["rounds_bits_differ"] == []
    assert d["bits_total_delta"] == 0.0
    with pytest.raises(ValueError, match="A12"):
        main([spec_path, "--out", t1, "--backend", "device"] + cpu)
