"""The port's round telemetry (``repro_torch.obs``) against the JAX
package's, and the cases of ``tests/test_obs.py`` on the port.

* Per-hop bits in a trace are the executor's HopStats, which on
  full-participation rounds equal the §V closed forms — on chain, tree and
  nested plans; the recorded critical path is ``round_latency_s``.
* ``plan_meta``, ``hop_timeline`` and ``record_round`` fed the same inputs
  give the reference's records, field by field except timing; ``report``'s
  summary and diff and ``chrome_events`` of one trace file agree across
  the packages; a JAX trace and a port trace of the same rounds (the port
  fed the reference's gradients) diff to zero bits; a port trace passes
  the reference's ``validate_trace``.
* The run reads its logs back once per flush (``_fetch_logs``), one copy
  per flush, and its curves do not depend on the cadence or on the
  collector; a disabled collector is a no-op.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.agg import nested as jn
from repro.agg import plan as jplan_mod
from repro.configs import PAPER as JPAPER
from repro.core.algorithms import AggConfig as JCfg
from repro.core.algorithms import HopStats as JHopStats
from repro.data.federated import client_minibatch as jminibatch
from repro.data.federated import partition_iid as jpartition
from repro.data.synthetic import make_synthetic_mnist as jmnist
from repro.fed import simulator as jsim
from repro.obs import chrome as jchrome
from repro.obs import report as jreport
from repro.topo import graph as jg
from repro.topo import routing as jr
from repro_torch import convert
from repro_torch.agg import compile_nested, compile_plan
from repro_torch.configs import PAPER
from repro_torch.core import comm_cost as cc
from repro_torch.core.algorithms import AggConfig, AggKind, HopStats
from repro_torch.data import (FederatedData, make_synthetic_mnist,
                              partition_iid)
from repro_torch.fed import simulator as sim_mod
from repro_torch.fed.simulator import Simulator
from repro_torch.fed.topology import FailureSchedule, TreeTopology
from repro_torch.obs import (RoundBuffer, TraceCollector, chrome_events,
                             export_chrome_trace, hop_timeline, iter_trace,
                             plan_meta, subtree_sizes_from_parent,
                             validate_trace)
from repro_torch.obs import report as treport
from repro_torch.obs.report import main as report_main
from repro_torch.runtime.fault import dead_banked_mass
from repro_torch.topo import graph as tg
from repro_torch.topo.routing import cluster_routed
from repro_torch.topo.tree import round_latency_s

torch.set_num_threads(1)

K = 8
PC = dataclasses.replace(PAPER, num_clients=K)
JPC = dataclasses.replace(JPAPER, num_clients=K)
IDX = cc.idx_bits(PC.d)


@pytest.fixture(scope="module")
def fed():
    train = make_synthetic_mnist(0, K * 40, device="cpu")
    return partition_iid(train, K, torch.Generator().manual_seed(2))


def _cfg(kind=AggKind.CL_SIA):
    return AggConfig(kind=kind, q=PC.q, q_global=PC.q_global,
                     q_local=PC.q_local)


def _sim(fed, kind=AggKind.CL_SIA, **kw):
    return Simulator(PC, _cfg(kind), fed, local_lr=PC.lr, device="cpu", **kw)


def _rounds(path):
    return [r for r in iter_trace(str(path)) if r["kind"] == "round"]


# ---------------------------------------------------------------------------
# Trace == HopStats == closed forms (tests/test_obs.py on the port)
# ---------------------------------------------------------------------------

def test_chain_trace_bits_exact(fed, tmp_path):
    path = tmp_path / "chain.jsonl"
    with TraceCollector(str(path)) as col:
        out = _sim(fed).run(5, collector=col, flush_every=2)
    assert validate_trace(str(path))["errors"] == []
    assert jobs.validate_trace(str(path))["errors"] == []
    per_hop = PC.q * (32 + IDX)
    for r, rec in enumerate(_rounds(path)):
        assert rec["stages"][0]["bits"] == [per_hop] * K
        assert rec["totals"]["bits"] == cc.cl_sia_bits(K, PC.d, PC.q)
        assert rec["totals"]["bits"] == out["bits"][r]
        assert rec["totals"]["bits_global"] == 0
        assert rec["totals"]["bits_local"] == rec["totals"]["bits"]
        sizes = subtree_sizes_from_parent(rec["plan"]["stages"][0]["parent"])
        assert sorted(sizes.tolist()) == list(range(1, K + 1))
        assert set(rec["phases"]) == {"plan", "dispatch"}


def test_tree_trace_crit_path_matches_link_model(fed, tmp_path):
    path = tmp_path / "tree.jsonl"
    topo = TreeTopology(tg.walker_delta(2, K // 2, gateways=(1, K // 2)),
                        routing="widest")
    with TraceCollector(str(path)) as col:
        _sim(fed, tree_topology=topo).run(4, collector=col)
    tree = topo.tree()
    for rec in _rounds(path):
        assert rec["totals"]["bits"] == cc.cl_sia_bits_tree(K, PC.d, PC.q)
        want = round_latency_s(tree, np.asarray(rec["stages"][0]["bits"]))
        assert rec["crit_path_s"] == pytest.approx(want, rel=1e-12)
        assert rec["crit_path_s"] == pytest.approx(
            max(rec["stages"][0]["t1_s"]))


def test_tc_sia_under_recorded_prop2_bound(fed, tmp_path):
    path = tmp_path / "tc.jsonl"
    with TraceCollector(str(path)) as col:
        _sim(fed, AggKind.TC_SIA).run(5, collector=col)
    for rec in _rounds(path):
        sizes = subtree_sizes_from_parent(rec["plan"]["stages"][0]["parent"])
        bound = cc.tc_sia_bits_bound_tree(sizes, PC.d, PC.q_global,
                                          PC.q_local, 32)
        assert rec["totals"]["bits"] <= 1.02 * bound
        assert rec["totals"]["bits_global"] + rec["totals"]["bits_local"] \
            == pytest.approx(rec["totals"]["bits"])


def test_nested_trace_per_stage_bits(fed, tmp_path):
    path = tmp_path / "nested.jsonl"
    nt = cluster_routed(tg.grid_graph(2, K // 2), 2)
    with TraceCollector(str(path)) as col:
        out = _sim(fed, nested_topology=nt).run(4, collector=col)
    assert validate_trace(str(path))["errors"] == []
    stage_want = cc.nested_cl_sia_bits([K, 2], PC.d, PC.q)
    for r, rec in enumerate(_rounds(path)):
        assert rec["plan"]["type"] == "nested"
        assert len(rec["stages"]) == 2
        assert [sum(s["bits"]) for s in rec["stages"]] == list(stage_want)
        assert rec["totals"]["bits"] == sum(stage_want) == out["bits"][r]
        assert len(rec["stages"][1]["ef_mass"]) == 2
    meta = next(iter_trace(str(path)))
    assert meta["topology"] == "nested" and meta["backend"] == "host"


def test_collector_adds_no_specialization(fed, tmp_path):
    bare = _sim(fed)
    bare.run(6)
    assert bare.trace_counter.count == 1
    traced = _sim(fed)
    with TraceCollector(str(tmp_path / "t.jsonl")) as col:
        traced.run(6, collector=col, flush_every=2)
    assert traced.trace_counter.count == 1
    assert {r["retraces"] for r in _rounds(tmp_path / "t.jsonl")} == {1}


def test_disabled_collector_is_noop(fed, tmp_path):
    path = tmp_path / "off.jsonl"
    col = TraceCollector(str(path), enabled=False)
    assert col.record_span("x", 0.0, 1.0) is None
    assert col.record_round(0, None) is None
    assert col.record_train_metrics(0, {}) is None
    col.close()
    assert not path.exists()
    assert TraceCollector(None).enabled is False
    # and a run under it returns the bare run's curves
    a = _sim(fed).run(3)
    b = _sim(fed).run(3, collector=TraceCollector(str(path), enabled=False))
    assert a["loss"] == b["loss"] and a["bits"] == b["bits"]
    assert not path.exists()


# ---------------------------------------------------------------------------
# Read-back batching: one _fetch_logs per flush, one copy per flush
# ---------------------------------------------------------------------------

def test_history_reads_once_per_flush(fed, monkeypatch):
    fetches = []
    real = sim_mod._fetch_logs
    monkeypatch.setattr(sim_mod, "_fetch_logs",
                        lambda buf: fetches.append(len(buf)) or real(buf))
    out = _sim(fed).run(10, flush_every=4)
    assert [n for n in fetches if n] == [4, 4, 2]
    assert len(out["bits"]) == 10
    fetches.clear()
    out = _sim(fed).run_batched(5, seeds=[0, 1], flush_every=2)
    assert [n for n in fetches if n] == [2, 2, 1]
    assert len(out["bits"]) == 5


def test_flush_cadence_does_not_change_curves(fed):
    a = _sim(fed).run(7, flush_every=1)
    b = _sim(fed).run(7, flush_every=100)
    assert a["loss"] == b["loss"]
    assert a["bits"] == b["bits"]
    assert a["nnz"] == b["nnz"]


def test_round_buffer_copies_every_leaf_bit_for_bit():
    """The flush returns the buffered structure with CPU copies of every
    tensor: dtypes, shapes and bits (−0.0, NaN, bools, ints) kept."""
    buf = RoundBuffer()
    payloads = []
    for r in range(3):
        stats = HopStats(*(torch.tensor([r, -0.0, float("nan")])
                           for _ in range(5)))
        payload = ((torch.tensor(float(r)), (stats,),
                    torch.tensor([True, False]), (), torch.arange(r + 1)),
                   None if r else torch.tensor(0.5))
        payloads.append(payload)
        buf.push(payload)
    assert len(buf) == 3
    got = buf.flush()
    assert len(buf) == 0 and buf.flush() == []
    for want, have in zip(payloads, got):
        (wl, ws, wb, we, wi), wacc = want
        (hl, hs, hb, he, hi), hacc = have
        assert isinstance(hs[0], HopStats) and he == ()
        for a, b in [(wl, hl), (wb, hb), (wi, hi)] + list(zip(ws[0],
                                                              hs[0])):
            assert a.dtype == b.dtype and a.shape == b.shape
            raw = lambda x: x.reshape(-1).view(torch.uint8)  # noqa: E731
            assert torch.equal(raw(a), raw(b))
        assert (wacc is None) == (hacc is None)


def test_dead_banked_mass_unit():
    ef = torch.tensor([[1., -2.], [3., 4.], [0., -5.]])
    part = torch.tensor([1., 0., 0.])
    assert float(dead_banked_mass(ef, part)) == pytest.approx(7.0 + 5.0)
    assert float(dead_banked_mass(ef, torch.ones(3))) == 0.0


def test_relay_death_exposes_ef_dead_mass(fed, tmp_path):
    path = tmp_path / "death.jsonl"
    topo = TreeTopology(tg.walker_delta(2, K // 2, gateways=(1, K // 2)),
                        routing="widest")
    fails = FailureSchedule(K, {2: ([0], []), 5: ([], [0])})
    with TraceCollector(str(path)) as col:
        _sim(fed, tree_topology=topo).run(7, failure_schedule=fails,
                                          collector=col)
    recs = _rounds(path)
    for rec in recs:
        dead = [m for m, p in zip(rec["stages"][0]["ef_mass"],
                                  rec["participation"]) if p == 0]
        assert rec["ef_dead_mass"] == pytest.approx(sum(dead), rel=1e-6)
    assert all(r["ef_dead_mass"] == 0 for r in recs[:2])
    assert all(r["ef_dead_mass"] > 0 for r in recs[2:5])
    assert all(r["ef_dead_mass"] == 0 for r in recs[5:])


def test_batched_rounds_record_one_record_per_cohort(fed, tmp_path):
    path = tmp_path / "batched.jsonl"
    with TraceCollector(str(path)) as col:
        out = _sim(fed, AggKind.TC_SIA).run_batched(3, seeds=[0, 5],
                                                    collector=col)
    assert validate_trace(str(path))["errors"] == []
    recs = _rounds(path)
    assert [(r["round"], r["cohort"]) for r in recs] == [
        (r, c) for r in range(3) for c in range(2)]
    for rec in recs:
        assert rec["totals"]["bits"] == out["bits"][rec["round"]][
            rec["cohort"]]
        assert rec["loss"] == out["loss"][rec["round"]][rec["cohort"]]
    summ = treport.summarize(str(path), cohort=1)
    assert summ["cohorts"] == [0, 1] and summ["rounds"] == 3
    assert next(iter_trace(str(path)))["cohorts"] == 2


# ---------------------------------------------------------------------------
# Schema validation + report CLI + Chrome export
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trace_file(fed, tmp_path_factory):
    path = tmp_path_factory.mktemp("obs") / "trace.jsonl"
    with TraceCollector(str(path)) as col:
        _sim(fed).run(5, collector=col, flush_every=2)
    return str(path)


def test_validate_rejects_malformed(trace_file, tmp_path):
    bad = tmp_path / "bad.jsonl"
    lines = open(trace_file).read().splitlines()
    round_line = next(ln for ln in lines
                      if json.loads(ln)["kind"] == "round")
    rec = json.loads(round_line)
    del rec["totals"]
    rec["stages"][0]["bits"] = "oops"
    bad.write_text("\n".join([lines[0], json.dumps(rec)]) + "\n")
    res = validate_trace(str(bad))
    assert any("bits" in e for e in res["errors"])
    assert any("totals" in e for e in res["errors"])
    assert res == jobs.validate_trace(str(bad))
    nometa = tmp_path / "nometa.jsonl"
    nometa.write_text(round_line + "\n")
    assert any("meta" in e for e in validate_trace(str(nometa))["errors"])


def test_report_cli(trace_file, tmp_path, capsys):
    assert report_main(["validate", trace_file]) == 0
    assert report_main(["summary", trace_file]) == 0
    txt = capsys.readouterr().out
    assert "bit-identical" in txt and "cl_sia" in txt
    assert report_main(["summary", trace_file, "--json"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["closed_form"]["matches"] == 5
    assert summary["rounds"] == 5
    assert report_main(["diff", trace_file, trace_file]) == 0
    assert "identical" in capsys.readouterr().out
    assert report_main(["export", trace_file, "--out",
                        str(tmp_path / "e.json")]) == 0
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"schema": "nope/9", "kind": "mystery"}\n')
    assert report_main(["validate", str(bad)]) == 1


def test_chrome_export(trace_file, tmp_path):
    out = export_chrome_trace(trace_file, str(tmp_path / "c.json"))
    doc = json.load(open(out))
    hops = [e for e in doc["traceEvents"] if e.get("cat") == "hop"]
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "span"]
    assert len(hops) == 5 * K
    assert spans
    assert all(e["dur"] > 0 for e in hops)
    starts = sorted({e["args"]["round"]: e["ts"] for e in hops}.items())
    assert all(a[1] < b[1] for a, b in zip(starts, starts[1:]))


def test_plan_meta_roundtrip():
    meta = plan_meta(compile_plan(K))
    assert meta["type"] == "flat" and len(meta["stages"]) == 1
    st = meta["stages"][0]
    assert len(st["parent"]) == K
    assert sum(1 for p in st["parent"] if p < 0) == 1
    assert subtree_sizes_from_parent(st["parent"]).max() == K


def test_record_train_metrics_adapter(tmp_path):
    path = tmp_path / "train.jsonl"
    with TraceCollector(str(path), d=PC.d, num_clients=4) as col:
        for step in range(3):
            col.record_train_metrics(step, {
                "agg_bits": 1234.0, "agg_nnz": 77.0, "agg_err_sq": 0.5,
                "loss": torch.tensor(2.0 - step * 0.1), "ef_mass": 9.0,
                "ef_dead_mass": 0.0})
    assert validate_trace(str(path))["errors"] == []
    recs = _rounds(path)
    assert [r["totals"]["bits"] for r in recs] == [1234.0] * 3
    assert recs[-1]["loss"] == pytest.approx(1.8)


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------

def _plan_pairs():
    """(reference plan, port plan): flat chain, routed tree, nested."""
    jwalk = jg.walker_delta(2, 4, gateways=(1, 5))
    twalk = tg.walker_delta(2, 4, gateways=(1, 5))
    from repro.fed.topology import TreeTopology as JTree
    return [
        (jplan_mod.compile_plan(K), compile_plan(K)),
        (JTree(jwalk, "widest").plan(dead=(2,)),
         TreeTopology(twalk, "widest").plan(dead=(2,))),
        (jn.compile_nested(jr.cluster_routed(jwalk, 2)),
         compile_nested(cluster_routed(twalk, 2))),
    ]


def test_plan_meta_and_hop_timeline_match_reference():
    rng = np.random.default_rng(0)
    for jp, tp in _plan_pairs():
        want, got = jobs.plan_meta(jp), plan_meta(tp)
        assert got == want
        for st in got["stages"]:
            n = len(st["parent"])
            bits = rng.integers(0, 5000, n).astype(np.float64)
            bw = rng.uniform(0.0, 2e6, n)
            bw[0] = 0.0
            lat = rng.uniform(0, 1e-3, n)
            for kw in ({}, dict(bw_bps=bw, latency_s=lat, t_start=0.25)):
                a = jobs.hop_timeline(st["parent"], st["level"], bits, **kw)
                b = hop_timeline(st["parent"], st["level"], bits, **kw)
                np.testing.assert_array_equal(a[0], b[0])
                np.testing.assert_array_equal(a[1], b[1])
                assert a[2] == b[2]


def _stats_pair(rng, n):
    leaves = [rng.integers(0, 80, n).astype(np.float32) for _ in range(3)]
    leaves += [rng.integers(0, 9000, n).astype(np.float32),
               rng.uniform(0, 3, n).astype(np.float32)]
    return (JHopStats(*(jnp.asarray(x) for x in leaves)),
            HopStats(*(torch.from_numpy(x) for x in leaves)))


def test_record_round_matches_reference_field_by_field(tmp_path):
    """Both collectors fed the same round (stats per stage, plan, routed
    tree, loss, participation, EF masses) write the same record, field by
    field except the phases' wall-clock seconds."""
    rng = np.random.default_rng(1)
    jwalk = jg.walker_delta(2, 4, gateways=(1, 5))
    twalk = tg.walker_delta(2, 4, gateways=(1, 5))
    from repro.fed.topology import TreeTopology as JTree
    jtree, ttree = JTree(jwalk, "widest").tree(), TreeTopology(
        twalk, "widest").tree()
    cases = [(jp, tp, None, None) for jp, tp in _plan_pairs()]
    cases.append((cases[1][0], cases[1][1], jtree, ttree))
    jpath, tpath = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jkw = dict(cfg=JCfg(kind="cl_tc_sia", q=78), d=7850, num_clients=K)
    tkw = dict(cfg=AggConfig(kind="cl_tc_sia", q=78), d=7850, num_clients=K)
    with jobs.TraceCollector(str(jpath), **jkw) as jcol, \
            TraceCollector(str(tpath), **tkw) as tcol:
        for r, (jp, tp, jt, tt) in enumerate(cases):
            units = [len(s["parent"]) for s in plan_meta(tp)["stages"]]
            pairs = [_stats_pair(rng, n) for n in units]
            part = (rng.random(K) < 0.8).astype(np.float32)
            ef = rng.uniform(0, 2, K).astype(np.float32)
            stage_ef = [rng.uniform(0, 2, n).astype(np.float32)
                        for n in units[1:]]
            common = dict(ef_dead_mass=np.float32(1.25), retraces=r + 1,
                          phases={"plan": 0.1}, cohort=r % 2 or None)
            jcol.record_round(r, [a for a, _ in pairs], plan=jp, tree=jt,
                              loss=jnp.float32(0.5 + r),
                              participate=jnp.asarray(part),
                              ef_mass=jnp.asarray(ef),
                              stage_ef_mass=[jnp.asarray(x)
                                             for x in stage_ef], **common)
            tcol.record_round(r, [b for _, b in pairs], plan=tp, tree=tt,
                              loss=torch.tensor(0.5 + r),
                              participate=torch.from_numpy(part),
                              ef_mass=torch.from_numpy(ef),
                              stage_ef_mass=[torch.from_numpy(x)
                                             for x in stage_ef], **common)
    jrecs, trecs = list(iter_trace(str(jpath))), list(iter_trace(str(tpath)))
    assert len(jrecs) == len(trecs) == len(cases) + 1
    for key in ("schema", "cfg", "d", "num_clients"):
        assert jrecs[0][key] == trecs[0][key]
    for a, b in zip(jrecs[1:], trecs[1:]):
        assert set(a) == set(b)
        for key in a:
            if key != "phases":
                assert a[key] == b[key], key


@pytest.fixture(scope="module")
def jfed():
    train = jmnist(jax.random.PRNGKey(0), K * 60)
    return jpartition(jax.random.PRNGKey(2), train, K)


def test_traces_of_the_same_rounds_diff_to_zero_bits(jfed, tmp_path):
    """Four nested TC-SIA rounds (data-dependent bits): the reference's
    rounds recorded by its collector, the port's rounds fed the
    reference's gradients recorded by the port's. Either package's diff
    shows zero bit deltas; either package reads the other's trace."""
    jtopo = jr.cluster_routed(jg.walker_delta(2, 4, gateways=(1, 5)), 2)
    ttopo = cluster_routed(tg.walker_delta(2, 4, gateways=(1, 5)), 2)
    kw = dict(kind="tc_sia", q=JPC.q, q_global=JPC.q_global,
              q_local=JPC.q_local)
    jsimu = jsim.Simulator(JPC, JCfg(**kw), jfed, nested_topology=jtopo)
    fed = FederatedData(x=torch.from_numpy(np.array(jfed.x)),
                        y=torch.from_numpy(np.array(jfed.y)).long())
    sim = Simulator(PC, AggConfig(**kw), fed, nested_topology=ttopo,
                    device="cpu")
    from repro.core import tcs as jtcs

    def jround(state, plan):
        rng, kb = jax.random.split(state.rng)
        params = jsim.unflatten_lr(state.flat_w, JPC)
        bx, by = jminibatch(jsimu.fed, kb, JPC.batch_size)
        g = jax.vmap(lambda x, y: -jsimu.local_lr * jsim.flatten_lr(
            jax.grad(jsim.lr_loss)(params, x, y)))(bx, by)
        gm = jtcs.global_mask(jtcs.TCSState(state.tcs_prev), state.flat_w,
                              jsimu.agg.q_global)
        res = jn.execute_nested(jsimu.agg, plan, g, state.ef,
                                jsimu.weights, stage_e=state.stage_ef,
                                global_mask=gm)
        alive = plan.client_alive()
        flat = state.flat_w + res.aggregate / jnp.maximum(
            jnp.sum(jsimu.weights * alive), 1e-9)
        new = state._replace(round=state.round + 1, flat_w=flat,
                             ef=res.e_new, tcs_prev=state.flat_w, rng=rng,
                             stage_ef=res.stage_e_new)
        return new, g, (res.stats,) + res.stage_stats, alive

    step = jax.jit(jround)
    jstate = jsimu.init(0)
    state = convert.sim_state(jstate, "cpu")
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    with jobs.TraceCollector(jpath, cfg=jsimu.agg, d=JPC.d,
                             num_clients=K) as jcol, \
            TraceCollector(tpath, cfg=sim.agg, d=PC.d,
                           num_clients=K) as tcol:
        for r in range(4):
            jnext, g, jstats, alive = step(jstate, jsimu._nested)
            state, log = sim.aggregate_step(state, sim._nested,
                                            torch.from_numpy(np.array(g)))
            jcol.record_round(r, jstats, plan=jsimu._nested,
                              participate=alive)
            tcol.record_round(r, log.stats, plan=sim._nested,
                              participate=log.participation)
            jstate = jnext
    for d in (jreport.diff(jpath, tpath), treport.diff(tpath, jpath)):
        assert d["common"] == 4 and d["rounds_bits_differ"] == []
        assert d["bits_total_delta"] == 0.0
    assert jobs.validate_trace(tpath)["errors"] == []
    assert validate_trace(jpath)["errors"] == []
    # the bits depend on the data: hops of one round carry different counts
    assert len(set(_rounds(tpath)[1]["stages"][0]["bits"])) > 1


def test_summary_diff_and_chrome_agree_across_packages(fed, tmp_path):
    """One trace file (a port scenario run: spans on both tracks, a
    crash, a routed tree) summarized, diffed and exported by each package:
    the same dicts and events."""
    from repro_torch.scenario import Crash, LinkFlap, Scenario, TopologySpec
    spec = Scenario(name="obs-parity", rounds=6, seed=2,
                    topology=TopologySpec(kind="walker_delta", clients=K,
                                          params={"num_planes": 2,
                                                  "sats_per_plane": 4,
                                                  "gateways": [1, 5]}),
                    crashes=(Crash(node=3, round=2, recover=4),),
                    link_flaps=(LinkFlap(link=(1, 5), start=1, down=2),))
    path = str(tmp_path / "s.jsonl")
    with TraceCollector(path) as col:
        _sim(fed).run(6, scenario=spec, collector=col, flush_every=4)
    assert treport.summarize(path) == jreport.summarize(path)
    assert treport.summarize(path, cohort=0) == jreport.summarize(
        path, cohort=0)
    assert treport.diff(path, path) == jreport.diff(path, path)
    recs = list(iter_trace(path))
    assert chrome_events(recs) == jchrome.chrome_events(recs)
    assert treport.load_trace(path) == jreport.load_trace(path)
    meta, rounds, _ = treport.load_trace(path)
    assert treport.closed_form_check(meta, rounds) == \
        jreport.closed_form_check(meta, rounds)
