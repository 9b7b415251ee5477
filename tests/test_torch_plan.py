"""Plans, ``execute`` and ``run_chain`` of the port against the JAX package,
plus the §V closed forms.

The JAX plan is converted with ``repro_torch.convert.agg_plan`` so both
packages run the identical schedule; inputs are numpy arrays from a seed.
Tolerance: none — the aggregate, the EF rows, every count and the bits are
compared bit for bit; ``err_sq`` (a row sum in XLA's order) to rtol 1e-6.
The star tree has all K clients as children of the PS, so its aggregate
checks that the port adds children in the reference's slot order.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from repro.agg import plan as jplan
from repro.core import chain as jchain
from repro.core import comm_cost as jcc
from repro.core.algorithms import AggConfig as JCfg
from repro.topo import tree as jtree
from repro_torch import convert
from repro_torch.agg import plan as tplan
from repro_torch.core import chain as tchain
from repro_torch.core import comm_cost as tcc
from repro_torch.core.algorithms import AggConfig as TCfg
from repro_torch.topo import tree as ttree

torch.set_num_threads(1)

K, D, Q = 6, 300, 17
KINDS = ["sia", "re_sia", "cl_sia", "tc_sia", "cl_tc_sia", "dense_ia"]
ERR_RTOL = 1e-6


def _topologies(lib):
    """(name, topology) pairs built with one package's own tree module."""
    return [("chain", K), ("order", [3, 0, 5, 1, 4, 2]),
            ("star", lib.star_tree(K)),
            ("tree", lib.AggTree(parent=(-1, 0, 0, 1, 1, -1))),
            ("stub", lib.AggTree(parent=(-1, 0, 0, 1, 1, -1),
                                 reachable=(True,) * 5 + (False,)))]


TOPOS = [n for n, _ in _topologies(ttree)]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return dict(g=(rng.standard_normal((K, D)) * 0.05).astype(np.float32),
                e=(rng.standard_normal((K, D)) * 0.01).astype(np.float32),
                w=rng.uniform(0.5, 1.5, K).astype(np.float32),
                gm=(rng.random(D) < 0.1).astype(np.float32),
                p=np.array([1, 1, 0, 1, 1, 1], np.float32))


def _same(a, b):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


def _assert_result(j, t):
    _same(j.aggregate, t.aggregate)
    _same(j.e_new, t.e_new)
    for name in ("nnz_out", "nnz_global", "nnz_local", "bits"):
        _same(getattr(j.stats, name), getattr(t.stats, name))
    np.testing.assert_allclose(np.asarray(j.stats.err_sq),
                               t.stats.err_sq.numpy(), rtol=ERR_RTOL)


def _jexec(cfg):
    return jax.jit(lambda plan, g, e, w, gm, p: jplan.execute(
        cfg, plan, g, e, w, global_mask=gm, participate=p))


@pytest.mark.parametrize("name", TOPOS)
@pytest.mark.parametrize("pad", [False, True])
def test_compile_plan_matches_reference(name, pad):
    jt = dict(_topologies(jtree))[name]
    tt = dict(_topologies(ttree))[name]
    jp = jplan.compile_plan(jt, num_clients=K)
    pad_to = (jp.shape[0] + 1, jp.shape[1] + 2) if pad else None
    if pad:
        jp = jp.pad(pad_to)
    tp = tplan.compile_plan(tt, num_clients=K, pad_to=pad_to)
    cp = convert.agg_plan(jp)
    for field in ("node_id", "slot_mask", "parent_row", "flat_pos",
                  "alive"):
        np.testing.assert_array_equal(getattr(tp, field), getattr(cp, field))
    assert (tp.num_clients, tp.num_sinks) == (cp.num_clients, cp.num_sinks)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["ref", "never"])
def test_execute_matches_reference(kind, mode):
    x = _inputs()
    jcfg = JCfg(kind=kind, q=Q, kernel_mode=mode)
    tcfg = TCfg(kind=kind, q=Q, kernel_mode=mode)
    run = _jexec(jcfg)
    # every topology unpadded and padded on the fused path (padding lanes
    # are valid == 0 lanes of the kernels); the hand-built tree padded on
    # the unfused one
    topos = [jt for _, jt in _topologies(jtree)]
    cases = [(jt, False) for jt in topos]
    cases += ([(jt, True) for jt in topos] if mode == "ref"
              else [(dict(_topologies(jtree))["tree"], True)])
    for jt, pad in cases:
        jp = jplan.compile_plan(jt, num_clients=K)
        if pad:
            jp = jp.pad((jp.shape[0] + 1, jp.shape[1] + 2))
        j = run(jp, x["g"], x["e"], x["w"], x["gm"], x["p"])
        t = tplan.execute(tcfg, convert.agg_plan(jp),
                          *(torch.from_numpy(x[k]) for k in "gew"),
                          global_mask=torch.from_numpy(x["gm"]),
                          participate=torch.from_numpy(x["p"]))
        _assert_result(j, t)


@pytest.mark.parametrize("kind", KINDS)
def test_run_chain_matches_reference_and_chain_plan(kind):
    x = _inputs(seed=1)
    jcfg, tcfg = JCfg(kind=kind, q=Q), TCfg(kind=kind, q=Q)
    j = jax.jit(lambda g, e, w, gm, p: jchain.run_chain(
        jcfg, g, e, w, global_mask=gm, participate=p))(
        x["g"], x["e"], x["w"], x["gm"], x["p"])
    args = [torch.from_numpy(x[k]) for k in "gew"]
    kw = dict(global_mask=torch.from_numpy(x["gm"]),
              participate=torch.from_numpy(x["p"]))
    t = tchain.run_chain(tcfg, *args, **kw)
    _assert_result(j, t)
    t2 = ttree.run_tree(tcfg, ttree.path_tree(K), *args, **kw)
    for a, b in zip((t.aggregate, t.e_new) + tuple(t.stats[:4]),
                    (t2.aggregate, t2.e_new) + tuple(t2.stats[:4])):
        assert torch.equal(a, b)


def test_plan_errors_and_latency_match_reference():
    with pytest.raises(ValueError, match="permutation"):
        tplan.compile_plan([0, 0, 1])
    with pytest.raises(ValueError, match="cycle"):
        ttree.AggTree(parent=(1, 2, 0))
    with pytest.raises(ValueError, match="shrink"):
        tplan.compile_plan(K).pad((1, 1))
    parent = (-1, 0, 0, 1, 1, -1)
    links = dict(uplink_bw_bps=(1e6, 2e6, 5e5, 1e6, 0.0, 3e6),
                 uplink_latency_s=(0.01, 0.02, 0.01, 0.03, 0.0, 0.005))
    bits = [1000.0 * (i + 1) for i in range(K)]
    assert ttree.round_latency_s(ttree.AggTree(parent=parent, **links),
                                 bits) == jtree.round_latency_s(
        jtree.AggTree(parent=parent, **links), bits)
    t = ttree.AggTree(parent=parent)
    np.testing.assert_array_equal(t.subtree_sizes(),
                                  jtree.AggTree(parent=parent).subtree_sizes())


@pytest.mark.parametrize("K_,d,q", itertools.product([1, 5, 28],
                                                     [100, 7850, 10**6],
                                                     [1, 78, 500]))
def test_comm_cost_closed_forms_match_reference(K_, d, q):
    qg, ql = q - max(1, round(0.1 * q)), max(1, round(0.1 * q))
    depths = list(range(1, K_ + 1))
    sizes = list(range(K_, 0, -1))
    calls = [("routing_dense_bits", (K_, d)),
             ("routing_sparse_bits", (K_, d, q)),
             ("dense_ia_bits", (K_, d)), ("cl_sia_bits", (K_, d, q)),
             ("cl_tc_sia_bits", (K_, d, qg, ql)),
             ("expected_lambda_nnz_bound", (K_, d, qg, ql)),
             ("tc_sia_bits_bound", (K_, d, qg, ql)),
             ("sia_bits_bound", (K_, d, q)),
             ("sia_bits_worst_case", (K_, d, q)),
             ("routing_dense_bits_tree", (depths, d)),
             ("routing_sparse_bits_tree", (depths, d, q)),
             ("dense_ia_bits_tree", (K_, d)),
             ("cl_sia_bits_tree", (K_, d, q)),
             ("cl_tc_sia_bits_tree", (K_, d, qg, ql)),
             ("expected_lambda_nnz_bound_tree", (sizes, d, qg, ql)),
             ("tc_sia_bits_bound_tree", (sizes, d, qg, ql)),
             ("sia_bits_worst_case_tree", (sizes, d, q)),
             ("single_transmission_bits", (d, q)),
             ("normalized_efficiency", (1e6, d, q))]
    for name, args in calls:
        assert getattr(tcc, name)(*args) == getattr(jcc, name)(*args), name
