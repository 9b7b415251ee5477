"""Multi-tenant batched rounds of the port against the JAX package.

* ``execute_batched`` on the same numpy inputs as jitted
  ``repro.agg.execute_batched``: the five algorithms × a shared chain, a
  shared tree and a stacked padded plan (chain, tree, chain padded past
  their common shape) × stragglers × a cohort-shared ``[B, d]`` TCS mask,
  on the fused path (the kernels' plain versions here; the reference in its
  ``"ref"`` mode) and unfused (``kernel_mode="never"`` on both sides). The
  aggregate, EF rows, ``nnz_*`` and ``bits`` are bitwise; ``err_sq`` to
  rtol 1e-5, the reference's own tolerance for its batched rounds.
* The port's batched round against its own sequential ``execute`` per
  cohort: bitwise, ``err_sq`` included.
* ``RoundScheduler`` beside the reference's: the same per-cohort results
  and the same specialization counts (2 for a chain/tree bucket and a
  K = 4 bucket), growth only with the bucket's shape, the tampered audit
  and the refusal of stacked submissions.
* ``Simulator.run_batched`` against the port's ``run`` per seed (curves
  and state bitwise, stragglers included); a batched round fed the
  reference's gradients against the reference's batched aggregation
  (state bitwise); ``round_fn_batched`` replaying the reference's
  minibatch draws against jitted ``round_fn_batched`` (loss to rtol 1e-4:
  the gradients' products sum in another order); and the errors.

Sizes: K = 6 clients, d = 64, B = 3 cohorts (the reference's own test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import agg as jagg
from repro.core.algorithms import AggConfig as JCfg
from repro.topo.tree import PS as JPS
from repro.topo.tree import AggTree as JTree
from repro_torch import convert
from repro_torch.agg import (CohortRound, RoundScheduler, compile_plan,
                             execute, execute_batched, stack_plans)
from repro_torch.core.algorithms import AggConfig
from repro_torch.topo.tree import PS, AggTree

torch.set_num_threads(1)

KINDS = ["sia", "re_sia", "cl_sia", "tc_sia", "cl_tc_sia"]
K, D, B = 6, 64, 3
PARENT = (PS, 0, 1, 1, 0, 3)
ERR_RTOL = 1e-5
# the port's mode → the reference's mode on the same path
MODES = {"auto": "ref", "never": "never"}


def _inputs(seed, k=K, d=D):
    r = np.random.default_rng(seed)
    return dict(g=r.standard_normal((k, d)).astype(np.float32),
                e=(0.1 * r.standard_normal((k, d))).astype(np.float32),
                w=r.uniform(0.5, 2.0, (k,)).astype(np.float32),
                p=(r.random((k,)) < 0.8).astype(np.float32),
                gm=(r.random((d,)) < 0.3).astype(np.float32))


def _stack(ins):
    return {n: np.stack([c[n] for c in ins]) for n in ins[0]}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


def _assert_result(ref, got, err_rtol=ERR_RTOL):
    """Aggregate, EF rows, nnz_* and bits bitwise; err_sq to ``err_rtol``
    (None: bitwise too)."""
    _same(ref.aggregate, got.aggregate)
    _same(ref.e_new, got.e_new)
    for name in ("nnz_out", "nnz_global", "nnz_local", "bits"):
        _same(getattr(ref.stats, name), getattr(got.stats, name))
    if err_rtol is None:
        _same(ref.stats.err_sq, got.stats.err_sq)
    else:
        np.testing.assert_allclose(np.asarray(ref.stats.err_sq),
                                   np.asarray(got.stats.err_sq),
                                   rtol=err_rtol, atol=1e-5)


def _cohort(res, i):
    return jax.tree.map(lambda x: np.asarray(x)[i], res)


def _plans(form):
    """(port plan, reference plan, per-cohort unpadded port plans)."""
    chain, tree = K, AggTree(parent=PARENT)
    jchain, jtree = K, JTree(parent=tuple(JPS if p == PS else p
                                          for p in PARENT))
    if form != "stacked":
        topo, jtopo = (chain, jchain) if form == "chain" else (tree, jtree)
        plan = compile_plan(topo)
        return plan, jagg.compile_plan(jtopo), [plan] * B
    own = [compile_plan(t) for t in (chain, tree, chain)]
    jown = [jagg.compile_plan(t) for t in (jchain, jtree, jchain)]
    shape = (max(p.shape[0] for p in own) + 1,
             max(p.shape[1] for p in own) + 2)
    return (stack_plans([p.pad(shape) for p in own]),
            jagg.stack_plans([p.pad(shape) for p in jown]), own)


def _cfgs(kind, mode):
    kw = dict(kind=kind, q=9, q_global=5, q_local=3)
    return (AggConfig(kernel_mode=mode, **kw),
            JCfg(kernel_mode=MODES[mode], **kw))


@pytest.mark.parametrize("form", ["chain", "tree", "stacked"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", KINDS)
def test_execute_batched_matches_reference(kind, mode, form):
    cfg, jcfg = _cfgs(kind, mode)
    plan, jplan, _ = _plans(form)
    x = _stack([_inputs(31 * i + 7) for i in range(B)])
    want = jax.jit(lambda pl, g, e, w, gm, p: jagg.execute_batched(
        jcfg, pl, g, e, w, global_mask=gm, participate=p))(
            jplan, x["g"], x["e"], x["w"], x["gm"], x["p"])
    got = execute_batched(cfg, plan, _t(x["g"]), _t(x["e"]), _t(x["w"]),
                          global_mask=_t(x["gm"]), participate=_t(x["p"]))
    assert convert.agg_plan(jplan).node_id.tolist() == plan.node_id.tolist()
    _assert_result(want, jax.tree.map(lambda t: t.numpy(), got))


@pytest.mark.parametrize("form", ["chain", "tree", "stacked"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", KINDS)
def test_execute_batched_matches_sequential_execute(kind, mode, form):
    cfg, _ = _cfgs(kind, mode)
    plan, _, own = _plans(form)
    ins = [_inputs(17 * i + 3) for i in range(B)]
    x = _stack(ins)
    got = execute_batched(cfg, plan, _t(x["g"]), _t(x["e"]), _t(x["w"]),
                          global_mask=_t(x["gm"]), participate=_t(x["p"]))
    for i, c in enumerate(ins):
        want = execute(cfg, own[i], _t(c["g"]), _t(c["e"]), _t(c["w"]),
                       global_mask=_t(c["gm"]), participate=_t(c["p"]))
        _assert_result(want, _cohort(got, i), err_rtol=None)


@pytest.mark.parametrize("impl", ["scan", "hist"])
@pytest.mark.parametrize("kind", KINDS)
def test_execute_batched_threshold_matches_reference(kind, impl):
    """Threshold Top-Q: the τ search counts (or bins) every cohort's lanes
    in one call, the TC kinds through the cohort form."""
    kw = dict(kind=kind, q=9, q_global=5, q_local=3, topq_impl="threshold",
              tau_impl=impl, hist_rounds=3 if impl == "scan" else 2)
    cfg, jcfg = AggConfig(**kw), JCfg(kernel_mode="ref", **kw)
    plan, jplan, own = _plans("stacked")
    ins = [_inputs(13 * i + 1) for i in range(B)]
    x = _stack(ins)
    want = jax.jit(lambda pl, g, e, w, gm, p: jagg.execute_batched(
        jcfg, pl, g, e, w, global_mask=gm, participate=p))(
            jplan, x["g"], x["e"], x["w"], x["gm"], x["p"])
    got = execute_batched(cfg, plan, _t(x["g"]), _t(x["e"]), _t(x["w"]),
                          global_mask=_t(x["gm"]), participate=_t(x["p"]))
    _assert_result(want, jax.tree.map(lambda t: t.numpy(), got))
    for i, c in enumerate(ins):
        seq = execute(cfg, own[i], _t(c["g"]), _t(c["e"]), _t(c["w"]),
                      global_mask=_t(c["gm"]), participate=_t(c["p"]))
        _assert_result(seq, _cohort(got, i), err_rtol=None)


@pytest.mark.parametrize("kind", ["tc_sia", "cl_tc_sia"])
def test_default_global_mask_takes_the_cohort_form(kind, monkeypatch):
    """``global_mask=None`` is zeros [B, d]: the TC algorithms hand the
    kernels a cohort-shared mask, and get the sequential round with a zero
    [d] mask."""
    from repro_torch.kernels import ops
    seen = []
    orig = ops.chain_accum_level if kind == "tc_sia" else ops.cl_fuse_level
    name = orig.__name__

    def spy(*a, **kw):
        seen.append(kw.get("gmask_cohorts"))
        return orig(*a, **kw)

    monkeypatch.setattr(ops, name, spy)
    cfg, _ = _cfgs(kind, "auto")
    ins = [_inputs(5 * i) for i in range(B)]
    x = _stack(ins)
    plan = compile_plan(AggTree(parent=PARENT))
    got = execute_batched(cfg, plan, _t(x["g"]), _t(x["e"]), _t(x["w"]))
    assert seen and set(seen) == {B}
    for i, c in enumerate(ins):
        want = execute(cfg, plan, _t(c["g"]), _t(c["e"]), _t(c["w"]))
        _assert_result(want, _cohort(got, i), err_rtol=None)


def test_execute_batched_rejects_shape_mismatches():
    cfg, _ = _cfgs("sia", "auto")
    x = {n: _t(v) for n, v in _stack([_inputs(i) for i in range(B)]).items()}
    plan = compile_plan(K)
    with pytest.raises(ValueError):
        execute_batched(cfg, plan, x["g"][:, :-1], x["e"][:, :-1],
                        x["w"][:, :-1])
    tree = compile_plan(AggTree(parent=PARENT))
    shape = (max(plan.shape[0], tree.shape[0]),
             max(plan.shape[1], tree.shape[1]))
    two = stack_plans([plan.pad(shape), tree.pad(shape)])
    with pytest.raises(ValueError):
        execute_batched(cfg, two, x["g"], x["e"], x["w"])   # 2 plans, 3
    with pytest.raises(ValueError):
        stack_plans([plan, tree])                          # not padded
    with pytest.raises(ValueError):
        stack_plans([])


# ---------------------------------------------------------------------------
# RoundScheduler beside the reference's
# ---------------------------------------------------------------------------

def _rounds(plans, seed0):
    """(port CohortRounds, reference CohortRounds) on the same inputs."""
    ours, theirs = [], []
    for i, (plan, jplan) in enumerate(plans):
        c = _inputs(seed0 + 11 * i, k=plan.num_clients)
        cid = f"t{seed0}-{i}"
        ours.append(CohortRound(cid, plan, _t(c["g"]), _t(c["e"]),
                                _t(c["w"]), _t(c["gm"]), _t(c["p"])))
        theirs.append(jagg.CohortRound(
            cid, jplan, jnp.asarray(c["g"]), jnp.asarray(c["e"]),
            jnp.asarray(c["w"]), jnp.asarray(c["gm"]), jnp.asarray(c["p"])))
    return ours, theirs


def _both_plans(topo):
    jtopo = topo
    if isinstance(topo, AggTree):
        jtopo = JTree(parent=tuple(JPS if p == PS else p
                                   for p in topo.parent))
    return compile_plan(topo), jagg.compile_plan(jtopo)


def _submit(sched, jsched, plans, seed0):
    ours, theirs = _rounds(plans, seed0)
    got, want = sched.submit(ours), jsched.submit(theirs)
    for r in ours:
        _assert_result(want[r.cohort_id],
                       jax.tree.map(lambda t: t.numpy(), got[r.cohort_id]))
        seq = execute(sched.cfg, r.plan, r.grads, r.e, r.weights,
                      global_mask=r.global_mask, participate=r.participate)
        _assert_result(seq, got[r.cohort_id], err_rtol=None)


@pytest.mark.parametrize("kind", ["cl_sia", "tc_sia"])
def test_scheduler_one_specialization_per_bucket(kind):
    cfg, jcfg = _cfgs(kind, "auto")
    sched, jsched = RoundScheduler(cfg), jagg.RoundScheduler(jcfg)
    chain, tree = _both_plans(K), _both_plans(AggTree(parent=PARENT))
    small = _both_plans(4)                        # another K: own bucket
    for seed0 in (0, 100, 200):                   # 3 submits, same shapes
        _submit(sched, jsched, [chain, tree, chain, small], seed0)
    assert sched.expected_specializations == 2
    assert sched.trace_counter.count == jsched.trace_counter.count == 2
    sched.assert_bucket_specializations()


def test_scheduler_retraces_only_on_shape_growth():
    cfg, jcfg = _cfgs("sia", "auto")
    sched, jsched = RoundScheduler(cfg), jagg.RoundScheduler(jcfg)
    chain, tree = _both_plans(K), _both_plans(AggTree(parent=PARENT))
    _submit(sched, jsched, [chain, chain], 0)
    n0 = sched.trace_counter.count
    _submit(sched, jsched, [chain, chain], 7)     # same bucket: no new one
    assert sched.trace_counter.count == n0
    _submit(sched, jsched, [tree, chain], 13)     # grows (L, W)
    assert sched.trace_counter.count == n0 + 1
    sched.assert_bucket_specializations()
    _submit(sched, jsched, [chain, tree, chain], 23)   # B = 3 pads to 4
    sched.assert_bucket_specializations()
    assert sched.trace_counter.count == jsched.trace_counter.count
    assert sched.bucket_log[-1]["padded_cohorts"] == 4
    # a tampered audit trips: pretend a spec was never recorded
    sched._specs.pop()
    with pytest.raises(AssertionError):
        sched.assert_bucket_specializations()


def test_scheduler_counts_a_leaking_shape():
    """The counter reads the signature from the tensors the batched launch
    is given, not from the scheduler's bucket keys: a launch at a shape no
    bucket recorded is a new specialization, and the audit reports it."""
    cfg, _ = _cfgs("sia", "auto")
    sched = RoundScheduler(cfg)
    chain = compile_plan(K)
    ours, _ = _rounds([(chain, None)] * 2, 0)
    sched.submit(ours)
    assert sched.trace_counter.count == sched.expected_specializations == 1
    x = {n: torch.stack([getattr(r, n) for r in ours])
         for n in ("grads", "e", "weights", "global_mask", "participate")}
    sched._run(stack_plans([chain] * 2), *x.values())
    assert sched.trace_counter.count == 1          # the bucket's signature
    leaked = chain.pad((chain.shape[0] + 1, chain.shape[1]))
    sched._run(stack_plans([leaked] * 2), *x.values())
    assert sched.trace_counter.count == 2
    with pytest.raises(AssertionError):
        sched.assert_bucket_specializations()


def test_scheduler_rejects_stacked_submissions():
    cfg, _ = _cfgs("sia", "auto")
    sched = RoundScheduler(cfg)
    chain = compile_plan(4)
    c = _inputs(0, k=4)
    with pytest.raises(ValueError):
        sched.submit([CohortRound("x", stack_plans([chain, chain]),
                                  _t(c["g"]), _t(c["e"]), _t(c["w"]))])


# ---------------------------------------------------------------------------
# Simulator.run_batched
# ---------------------------------------------------------------------------

SIM_K = 8


@pytest.fixture(scope="module")
def sims():
    """(port fed data, reference simulator factory) at K = 8."""
    from repro.configs import PAPER as JPAPER
    from repro.data.federated import partition_iid as jpartition
    from repro.data.synthetic import make_synthetic_mnist as jmnist
    from repro_torch.data import FederatedData
    jpc = dataclasses.replace(JPAPER, num_clients=SIM_K)
    train = jmnist(jax.random.PRNGKey(0), SIM_K * 60)
    jfed = jpartition(jax.random.PRNGKey(2), train, SIM_K)
    fed = FederatedData(x=torch.from_numpy(np.array(jfed.x)),
                        y=torch.from_numpy(np.array(jfed.y)).long())
    return jpc, jfed, fed


def _sim(sims, kind, **kw):
    from repro_torch.configs import PAPER
    from repro_torch.fed import Simulator
    pc = dataclasses.replace(PAPER, num_clients=SIM_K)
    cfg = AggConfig(kind=kind, q=pc.q, q_global=pc.q_global,
                    q_local=pc.q_local)
    return Simulator(pc, cfg, sims[2], device="cpu", **kw)


def _jsim(sims, kind):
    from repro.fed import simulator as jsim
    jpc, jfed, _ = sims
    cfg = JCfg(kind=kind, q=jpc.q, q_global=jpc.q_global,
               q_local=jpc.q_local)
    return jsim.Simulator(jpc, cfg, jfed)


def _state_same(a, b):
    for x, y in ((a.flat_w, b.flat_w), (a.ef, b.ef),
                 (a.tcs_prev, b.tcs_prev)):
        _same(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("kind", KINDS)
def test_run_batched_equals_run_per_seed(sims, kind):
    sim = _sim(sims, kind)
    seeds = [0, 5, 9]
    out = sim.run_batched(3, seeds=seeds, eval_every=2,
                          test_x=sim.fed.x[0], test_y=sim.fed.y[0])
    assert np.asarray(out["loss"]).shape == (3, len(seeds))
    for i, s in enumerate(seeds):
        ref = sim.run(3, seed=s, eval_every=2, test_x=sim.fed.x[0],
                      test_y=sim.fed.y[0])
        for key in ("loss", "bits", "nnz"):
            assert [row[i] for row in out[key]] == ref[key], key
        assert [(r, a[i]) for r, a in out["accuracy"]] == ref["accuracy"]
        st = out["state"]
        _state_same(ref["state"], type(st)(
            round=st.round, flat_w=st.flat_w[i], ef=st.ef[i],
            tcs_prev=st.tcs_prev[i]))


def test_run_batched_straggler_masks(sims):
    from repro_torch.topo import star_tree
    sim = _sim(sims, "cl_tc_sia")
    drop = torch.ones(SIM_K)
    drop[2] = 0.0
    per_cohort = torch.ones(2, SIM_K)
    per_cohort[1, 5] = 0.0
    for fn, masks in ((lambda r, s: drop, [drop, drop]),
                      (lambda r, s: per_cohort, list(per_cohort))):
        out = sim.run_batched(3, seeds=[0, 1], participate_fn=fn,
                              topology=star_tree(SIM_K))
        assert np.all(np.isfinite(np.asarray(out["loss"])))
        for i, (s, m) in enumerate(zip([0, 1], masks)):
            ref = sim.run(3, seed=s, participate_fn=lambda r, st, m=m: m,
                          topology=star_tree(SIM_K))
            assert [row[i] for row in out["loss"]] == ref["loss"]
            assert [row[i] for row in out["bits"]] == ref["bits"]


def _jcohort_grads(jsim_, jpc):
    """The reference batched round's minibatch indices and gradients, as a
    jitted function of its state (its own draws: vmap(split) of the
    cohort keys, then client_minibatch's split over the clients)."""
    from repro.data.federated import client_minibatch as jminibatch
    from repro.fed import simulator as jsim

    def one(flat_w, key):
        params = jsim.unflatten_lr(flat_w, jpc)
        bx, by = jminibatch(jsim_.fed, key, jpc.batch_size)
        g = jax.vmap(lambda x, y: -jsim_.local_lr * jsim.flatten_lr(
            jax.grad(jsim.lr_loss)(params, x, y)))(bx, by)
        keys = jax.random.split(key, jsim_.k)
        idx = jax.vmap(lambda kk: jax.random.randint(
            kk, (jpc.batch_size,), 0, jsim_.fed.x.shape[1]))(keys)
        return g, idx

    def grads(state):
        kb = jax.vmap(jax.random.split)(state.rng)[:, 1]
        return jax.vmap(one)(state.flat_w, kb)

    return jax.jit(grads)


@pytest.mark.parametrize("kind", KINDS)
def test_batched_round_with_reference_grads_is_bitwise(sims, kind):
    """A mid-training batched state and the reference's gradients: the
    port's batched aggregation gives the reference batched round's state
    bit for bit (the reference's own update, jitted)."""
    from repro.core import tcs as jtcs
    from repro.fed import simulator as jsim
    jpc = sims[0]
    jsimu = _jsim(sims, kind)
    rng = np.random.default_rng(11)
    flat = (rng.standard_normal((B, jpc.d)) * 0.05).astype(np.float32)
    state = jsim.SimState(
        round=jnp.int32(2), flat_w=jnp.asarray(flat),
        ef=jnp.asarray((rng.standard_normal((B, SIM_K, jpc.d)) * 1e-3)
                       .astype(np.float32)),
        tcs_prev=jnp.asarray(flat - (rng.standard_normal((B, jpc.d))
                                     * 1e-3).astype(np.float32)),
        rng=jax.vmap(jax.random.PRNGKey)(jnp.arange(B)))
    g, _ = _jcohort_grads(jsimu, jpc)(state)
    jplan = jagg.compile_plan(JTree(parent=(JPS, 0, 0, 1, 1, 2, 2, 3)))
    part = np.ones((B, SIM_K), np.float32)
    part[1, 4] = 0.0

    def agg(state, plan, g, part):
        cfg, w = jsimu.agg, jsimu.weights
        gm, prev = None, state.tcs_prev
        if cfg.kind in ("tc_sia", "cl_tc_sia"):
            gm = jax.vmap(lambda pr, fw: jtcs.global_mask(
                jtcs.TCSState(pr), fw, cfg.q_global))(prev, state.flat_w)
            prev = state.flat_w
        res = jagg.execute_batched(cfg, plan, g, state.ef,
                                   jnp.broadcast_to(w, (B, SIM_K)),
                                   global_mask=gm, participate=part)
        alive = jnp.broadcast_to(jnp.asarray(plan.alive), (B, SIM_K))
        d_total = jnp.maximum(jnp.sum(w * part * alive, axis=1), 1e-9)
        return (state.flat_w + res.aggregate / d_total[:, None], res.e_new,
                prev, res.stats)

    flat_w, e_new, prev, stats = jax.jit(agg)(state, jplan, g,
                                              jnp.asarray(part))
    sim = _sim(sims, kind)
    tstate = convert.sim_state(state, "cpu")
    new, log = sim.aggregate_step_batched(
        tstate, convert.agg_plan(jplan), torch.from_numpy(np.array(g)),
        torch.from_numpy(part))
    for a, b in ((flat_w, new.flat_w), (e_new, new.ef), (prev, new.tcs_prev),
                 (stats.bits, log.stats[0].bits),
                 (stats.nnz_out, log.stats[0].nnz_out),
                 (stats.nnz_local, log.stats[0].nnz_local)):
        _same(np.asarray(a), b.numpy())
    assert new.round == int(state.round) + 1


@pytest.mark.parametrize("kind", ["cl_sia", "tc_sia"])
def test_round_fn_batched_replays_reference_draws(sims, kind):
    """Three batched rounds, the port fed the reference's minibatch
    indices: the loss of every cohort to rtol 1e-4, the model to 1e-5."""
    jpc = sims[0]
    jsimu = _jsim(sims, kind)
    jstate = jsimu.init_batched([0, 1, 2])
    jplan = jagg.compile_plan(SIM_K)
    step = jax.jit(jsimu.round_fn_batched())
    draws = _jcohort_grads(jsimu, jpc)
    sim = _sim(sims, kind)
    state = sim.init_batched([0, 1, 2])
    _state_same(state, jstate)
    plan = convert.agg_plan(jplan)
    for _ in range(3):
        _, idx = draws(jstate)
        jstate, jlog = step(jstate, jplan)
        state, log = sim.round_fn_batched(
            state, plan, batch_idx=torch.from_numpy(np.array(idx)))
        np.testing.assert_allclose(log.loss.numpy(), np.asarray(jlog.loss),
                                   rtol=1e-4)
    np.testing.assert_allclose(state.flat_w.numpy(),
                               np.asarray(jstate.flat_w), rtol=1e-5,
                               atol=1e-6)


def test_run_batched_errors(sims):
    from repro_torch.fed.topology import FailureSchedule, TreeTopology
    from repro_torch.topo import cluster_routed, star_tree, walker_delta
    sim = _sim(sims, "cl_sia")
    from repro_torch.obs import TraceCollector
    # trace collection is ported: a disabled collector runs, and the
    # refusals below are the reference's
    assert len(sim.run_batched(1, seeds=[0],
                               collector=TraceCollector(None))["loss"]) == 1
    graph = walker_delta(2, 4)
    nested = cluster_routed(graph, 2)
    with pytest.raises(ValueError, match="nested"):
        sim.run_batched(1, seeds=[0], topology=nested)
    with pytest.raises(ValueError, match="tree_topology"):
        sim.run_batched(1, seeds=[0],
                        failure_schedule=FailureSchedule(SIM_K, {}))
    with pytest.raises(ValueError, match="taken alone"):
        sim.run_batched(1, seeds=[0], topology=star_tree(SIM_K),
                        order_fn=lambda r, s: list(range(SIM_K)))
    tree_sim = _sim(sims, "cl_sia",
                    tree_topology=TreeTopology(graph, "widest"))
    with pytest.raises(ValueError, match="chain-mode"):
        tree_sim.run_batched(1, seeds=[0],
                             order_fn=lambda r, s: list(range(SIM_K)))
