"""The port's ``Aggregator`` and ``run_chain_with_topology`` against the
JAX package's.

The same numpy arrays (from a seed) go to both packages; the reference
runs under ``jax.jit`` (XLA contracts ``a*b+c`` into FMAs, which the port
mirrors). Compared bit for bit: the aggregate, the EF rows, the TCS state,
every count and the §V bits. Structured gradients flatten in the order of
``jax.flatten_util.ravel_pytree`` (a dict's entries by sorted key), which
the port writes out by hand; a test feeds ``{"w": …, "b": …}`` to both and
compares the flat rows and the unflattened aggregate. The cases of
``tests/test_chain_properties.py`` and the aggregator cases of
``tests/test_agg_plan.py`` follow, on the port alone.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.agg import Aggregator as JAggregator
from repro.agg import aggregator as jaggmod
from repro.core import chain as jchain
from repro.core.algorithms import AggConfig as JCfg
from repro.fed.topology import TreeTopology as JTreeTopology
from repro.topo import graph as jg
from repro_torch.agg import (Aggregator, AggState, compile_plan, execute,
                             flat_dim)
from repro_torch.agg import aggregator as taggmod
from repro_torch.core import comm_cost as cc
from repro_torch.core import sparsify as sp
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.core.chain import run_chain, run_chain_with_topology
from repro_torch.fed.topology import TreeTopology
from repro_torch.topo import graph as tg

torch.set_num_threads(1)

KINDS = ["sia", "re_sia", "cl_sia", "tc_sia", "cl_tc_sia", "dense_ia"]
D = 7 * 9 + 5                      # {"w": [7, 9], "b": [5]}


def _same(a, b, msg=""):
    a, b = np.asarray(a), b.detach().cpu().numpy()
    assert a.shape == b.shape, msg
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _topology(name, lib):
    if name == "chain":
        return None, 12
    if name == "order":
        return [5, 2, 9, 0, 11, 3, 7, 1, 10, 4, 8, 6], 12
    graph = (jg if lib == "jax" else tg).walker_delta(3, 4, gateways=(1, 7))
    topo = (JTreeTopology if lib == "jax" else TreeTopology)(graph, "widest")
    return topo, graph.num_clients


def _grads(k, seed, structured):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, 7, 9)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((k, 5)) * 0.05).astype(np.float32)
    if structured:
        return {"w": w, "b": b}
    return np.concatenate([b, w.reshape(k, -1)], axis=1)


def _to_torch(x):
    if isinstance(x, dict):
        return {key: torch.from_numpy(v.copy()) for key, v in x.items()}
    return torch.from_numpy(x.copy())


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((7, 9)) * 0.1).astype(np.float32),
            "b": (rng.standard_normal(5) * 0.1).astype(np.float32)}


def test_flattening_follows_ravel_pytree():
    """Dict leaves by sorted key, sequences in order, row-major: the flat
    rows, the unflattened aggregate and flat_dim are the reference's."""
    k = 4
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((k, 3, 4)).astype(np.float32),
            "b": rng.standard_normal((k, 5)).astype(np.float32),
            "a": [rng.standard_normal((k, 2)).astype(np.float32),
                  (rng.standard_normal((k, 1, 3)).astype(np.float32),)]}
    ttree = {"w": torch.from_numpy(tree["w"]),
             "b": torch.from_numpy(tree["b"]),
             "a": [torch.from_numpy(tree["a"][0]),
                   (torch.from_numpy(tree["a"][1][0]),)]}
    d = 12 + 5 + 2 + 3
    jflat, junravel = jaggmod._as_flat_stack(
        jax.tree.map(jnp.asarray, tree), k, d)
    tflat, tunravel = taggmod._as_flat_stack(ttree, k, d)
    _same(jflat, tflat)
    vec = np.arange(d, dtype=np.float32)
    jout, tout = junravel(jnp.asarray(vec)), tunravel(torch.from_numpy(vec))
    assert sorted(tout) == ["a", "b", "w"]
    assert isinstance(tout["a"], list) and isinstance(tout["a"][1], tuple)
    for jl, tl in zip(jax.tree.leaves(jout),
                      [tout["a"][0], tout["a"][1][0], tout["b"], tout["w"]]):
        _same(jl, tl)
    one = jax.tree.map(lambda x: x[0], tree)
    _same(ravel_pytree(one)[0], taggmod.ravel(
        jax.tree.map(torch.from_numpy, one))[0])
    assert flat_dim(ttree) == jaggmod.flat_dim(tree) == k * d


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("topo", ["chain", "order", "walker"])
@pytest.mark.parametrize("structured", [False, True],
                         ids=["array", "dict"])
def test_aggregator_rounds_match_reference(kind, topo, structured):
    """Two rounds (the second with a moved model, so the TC algorithms'
    global mask is live) with a straggler: aggregate, EF, TCS state, stats
    and total bits bit for bit."""
    jtopo, k = _topology(topo, "jax")
    ttopo, _ = _topology(topo, "torch")
    jagg = JAggregator(JCfg(kind=kind, q=9, q_global=7, q_local=2), k, D,
                       topology=jtopo)
    tagg = Aggregator(AggConfig(kind=kind, q=9, q_global=7, q_local=2), k,
                      D, topology=ttopo, device="cpu")
    jround = jax.jit(lambda g, st, w, params, p: jagg.round(
        g, st, w, params=params, participate=p))
    w = np.linspace(0.5, 1.5, k).astype(np.float32)
    part = np.ones(k, np.float32)
    part[k // 3] = 0.0
    p0 = _params(1)
    jst, tst = jagg.init_state(p0), tagg.init_state(_to_torch(p0))
    for r in range(2):
        g = _grads(k, 10 + r, structured)
        params = _params(2 + r)
        jo = jround(jax.tree.map(jnp.asarray, g), jst, jnp.asarray(w),
                    params, jnp.asarray(part))
        to = tagg.round(_to_torch(g), tst, torch.from_numpy(w),
                        params=_to_torch(params),
                        participate=torch.from_numpy(part))
        if structured:
            assert sorted(to.aggregate) == ["b", "w"]
            for key in ("w", "b"):
                _same(jo.aggregate[key], to.aggregate[key], f"{r} {key}")
        else:
            _same(jo.aggregate, to.aggregate, f"round {r}")
        _same(jo.state.ef, to.state.ef)
        if jo.state.tcs_prev is None:
            assert to.state.tcs_prev is None
        else:
            _same(jo.state.tcs_prev, to.state.tcs_prev)
        for name in ("nnz_out", "nnz_global", "nnz_local", "bits"):
            _same(getattr(jo.stats, name), getattr(to.stats, name), name)
        _same(jo.total_bits, to.total_bits)
        jst, tst = jo.state, to.state


def _tied_params(seed):
    """Parameters on a 0.05 grid: the model's motion has tied magnitudes,
    so the threshold sparsifier keeps more than Q_G where the exact one
    keeps Q_G."""
    return {key: (np.round(v * 20) / 20).astype(np.float32)
            for key, v in _params(seed).items()}


@pytest.mark.parametrize("kind", ["tc_sia", "cl_tc_sia"])
@pytest.mark.parametrize("tau_impl", ["scan", "hist"])
def test_threshold_global_mask_through_aggregator(kind, tau_impl):
    """Under topq_impl="threshold" the TCS global mask comes from the
    threshold sparsifier (cfg.topq_mask_fn), as in the reference."""
    jtopo, k = _topology("walker", "jax")
    ttopo, _ = _topology("walker", "torch")
    kw = dict(kind=kind, q=9, q_global=7, q_local=2, topq_impl="threshold",
              tau_impl=tau_impl, hist_rounds=2 if tau_impl == "hist" else 3)
    jagg = JAggregator(JCfg(**kw), k, D, topology=jtopo)
    tagg = Aggregator(AggConfig(**kw), k, D, topology=ttopo, device="cpu")
    jround = jax.jit(lambda g, st, w, params: jagg.round(g, st, w,
                                                         params=params))
    w = np.ones(k, np.float32)
    p0 = _tied_params(1)
    jst, tst = jagg.init_state(p0), tagg.init_state(_to_torch(p0))
    for r in range(2):
        g = _grads(k, 20 + r, False)
        params = _tied_params(5 + r)
        # the two sparsifiers disagree on this round's motion
        delta = (taggmod.ravel(_to_torch(params))[0]
                 - taggmod.ravel(_to_torch(_tied_params(1 if r == 0
                                                        else 5)))[0])
        assert not torch.equal(tagg.cfg.topq_mask_fn()(delta, 7),
                               sp.topq_mask(delta, 7))
        jo = jround(jnp.asarray(g), jst, jnp.asarray(w), params)
        to = tagg.round(torch.from_numpy(g), tst, torch.from_numpy(w),
                        params=_to_torch(params))
        _same(jo.aggregate, to.aggregate, f"round {r}")
        _same(jo.state.ef, to.state.ef)
        _same(jo.state.tcs_prev, to.state.tcs_prev)
        _same(jo.stats.bits, to.stats.bits)
        _same(jo.stats.nnz_global, to.stats.nnz_global)
        jst, tst = jo.state, to.state


def test_aggregator_plan_override_and_errors():
    k = 12
    topo, _ = _topology("walker", "torch")
    agg = Aggregator(AggConfig(kind=AggKind.CL_SIA, q=9), k, D,
                     topology=topo, device="cpu")
    g = torch.from_numpy(_grads(k, 3, False))
    w = torch.ones(k)
    out = agg.round(g, agg.init_state(), w)
    want = execute(agg.cfg, compile_plan(topo), g, torch.zeros(k, D), w)
    assert torch.equal(out.aggregate, want.aggregate)
    out2 = agg.round(g, agg.init_state(), w, plan=compile_plan(k))
    assert torch.equal(out2.aggregate,
                       run_chain(agg.cfg, g, torch.zeros(k, D), w).aggregate)
    assert isinstance(out2.state, AggState)
    with pytest.raises(ValueError, match="12"):
        Aggregator(agg.cfg, 5, D, plan=compile_plan(12), device="cpu")
    with pytest.raises(ValueError, match="aggregator takes"):
        agg.round(g[:, :5], agg.init_state(), w)
    with pytest.raises(ValueError, match="leading dim"):
        agg.round({"w": g[:3]}, agg.init_state(), w)
    tc = Aggregator(AggConfig(kind=AggKind.TC_SIA, q=9), k, D,
                    device="cpu")
    with pytest.raises(ValueError, match="params"):
        tc.round(g, tc.init_state(), w)


def test_deprecated_wrappers_still_work():
    from repro_torch.core.api import ChainAggregator, make_aggregator
    cfg = AggConfig(kind=AggKind.SIA, q=9)
    g = torch.from_numpy(_grads(6, 4, False))
    with pytest.warns(DeprecationWarning):
        agg = make_aggregator(cfg, 6, D, device="cpu")
    out = agg.round(g, agg.init_state(), torch.ones(6))
    want = run_chain(cfg, g, torch.zeros(6, D), torch.ones(6))
    assert torch.equal(out.aggregate, want.aggregate)
    with pytest.warns(DeprecationWarning):
        ChainAggregator(cfg, 6, D, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Aggregator(cfg, 6, D, device="cpu")


# --- run_chain_with_topology ------------------------------------------------

K, DC, Q = 7, 200, 9
ORDER = [3, 1, 6, 0, 2, 5, 4]


def _chain_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return dict(g=rng.standard_normal((K, DC)).astype(np.float32),
                e=(0.1 * rng.standard_normal((K, DC))).astype(np.float32),
                w=np.arange(1.0, K + 1, dtype=np.float32),
                gm=(rng.random(DC) < 0.1).astype(np.float32),
                p=np.asarray([1, 1, 0, 1, 1, 0, 1], np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_run_chain_with_topology_matches_reference(kind):
    x = _chain_inputs(1)
    jcfg, tcfg = JCfg(kind=kind, q=Q), AggConfig(kind=kind, q=Q)
    j = jax.jit(lambda g, e, w, o, gm, p: jchain.run_chain_with_topology(
        jcfg, g, e, w, o, global_mask=gm, participate=p))(
        x["g"], x["e"], x["w"], np.asarray(ORDER, np.int32), x["gm"], x["p"])
    args = [torch.from_numpy(x[key]) for key in "gew"]
    kw = dict(global_mask=torch.from_numpy(x["gm"]),
              participate=torch.from_numpy(x["p"]))
    t = run_chain_with_topology(tcfg, *args, ORDER, **kw)
    _same(j.aggregate, t.aggregate)
    _same(j.e_new, t.e_new)
    for name in ("nnz_out", "nnz_global", "nnz_local", "bits"):
        _same(getattr(j.stats, name), getattr(t.stats, name), name)
    # the order compile_plan takes is the same order
    p = execute(tcfg, compile_plan(ORDER), *args, **kw)
    assert torch.equal(p.aggregate, t.aggregate)
    assert torch.equal(p.e_new, t.e_new)
    assert torch.equal(p.stats.bits, t.stats.bits)
    with pytest.raises(ValueError, match="order"):
        run_chain_with_topology(tcfg, *args, ORDER[:3])


# --- the cases of tests/test_chain_properties.py ----------------------------

def _t(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("kind", KINDS)
def test_mass_conservation(kind):
    """γ₁ + Σ_k e'_k = Σ_k (D_k g_k + e_k): the chain loses nothing."""
    x = _chain_inputs(2)
    res = run_chain(AggConfig(kind=kind, q=Q), _t(x["g"]), _t(x["e"]),
                    _t(x["w"]), global_mask=sp.topq_mask(_t(x["g"][0]), 20))
    lhs = (res.aggregate + res.e_new.sum(0)).numpy()
    rhs = (_t(x["w"])[:, None] * _t(x["g"]) + _t(x["e"])).sum(0).numpy()
    np.testing.assert_allclose(lhs, rhs, rtol=2e-4, atol=2e-4)


def test_cl_closed_forms_and_sia_bounds():
    x = _chain_inputs(3)
    g, zeros, ones = _t(x["g"]), torch.zeros(K, DC), torch.ones(K)
    cl = run_chain(AggConfig(kind=AggKind.CL_SIA, q=Q), g, zeros, ones)
    assert float(cl.stats.bits.sum()) == cc.cl_sia_bits(K, DC, Q)
    assert int(cl.stats.nnz_out.max()) <= Q
    qg, ql = 20, 3
    mask = sp.topq_mask(_t(_chain_inputs(5)["g"][0]), qg)
    cltc = run_chain(AggConfig(kind=AggKind.CL_TC_SIA, q=qg + ql,
                               q_global=qg, q_local=ql), g, zeros, ones,
                     global_mask=mask)
    assert float(cltc.stats.bits.sum()) == cc.cl_tc_sia_bits(K, DC, qg, ql)
    sia = run_chain(AggConfig(kind=AggKind.SIA, q=Q), g, zeros, ones)
    bits = float(sia.stats.bits.sum())
    assert cc.cl_sia_bits(K, DC, Q) <= bits <= cc.sia_bits_worst_case(
        K, DC, Q)


def test_topology_reordering_preserves_dense_aggregate():
    x = _chain_inputs(4)
    cfg = AggConfig(kind=AggKind.DENSE_IA, q=1)
    g, zeros, ones = _t(x["g"]), torch.zeros(K, DC), torch.ones(K)
    r1 = run_chain(cfg, g, zeros, ones)
    r2 = run_chain_with_topology(cfg, g, zeros, ones, ORDER)
    np.testing.assert_allclose(r1.aggregate.numpy(), r2.aggregate.numpy(),
                               rtol=2e-4, atol=1e-5)
