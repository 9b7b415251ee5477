"""Cohort-batched rounds on the port's client mesh
(``repro_torch.agg.device.execute_sharded_batched``) against the JAX
package's batched host executor and the port's own.

* ``execute_sharded_batched`` on the same numpy inputs as jitted
  ``repro.agg.execute_batched``: the six kinds × a shared chain, a shared
  tree and a stacked padded plan (chain, tree, chain padded past their
  common shape — a rank is real in some cohorts and not in others at a
  level) × stragglers × a cohort-shared ``[B, d]`` TCS mask. The
  aggregate, EF rows, ``nnz_*`` and ``bits`` are bitwise; ``err_sq`` to
  rtol 1e-5, the reference's own tolerance for its batched rounds.
* Against the port's ``execute_batched``: bitwise, ``err_sq`` included,
  also under threshold Top-Q, the unfused path and bf16 gradients.
* ``Simulator.run_batched(backend="device")`` equals the host backend's
  batched run bit for bit.

Sizes: K = 6 clients, d = 64, B = 3 cohorts (the reference's own test).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import agg as jagg
from repro.core.algorithms import AggConfig as JCfg
from repro.topo.tree import PS as JPS
from repro.topo.tree import AggTree as JTree
from repro_torch.agg import compile_plan, execute_batched, stack_plans
from repro_torch.agg.device import client_mesh, execute_sharded_batched
from repro_torch.configs import PAPER
from repro_torch.core.algorithms import AggConfig
from repro_torch.data import make_synthetic_mnist, partition_iid
from repro_torch.fed import Simulator
from repro_torch.topo import star_tree
from repro_torch.topo.tree import PS, AggTree

torch.set_num_threads(1)

KINDS = ["sia", "re_sia", "cl_sia", "tc_sia", "cl_tc_sia", "dense_ia"]
K, D, B = 6, 64, 3
PARENT = (PS, 0, 1, 1, 0, 3)
ERR_RTOL = 1e-5
MESH = client_mesh(K, devices=["cpu"] * K)


def _tcs_mask(r):
    """A TCS mask as the simulator makes it: Q_G = 5 ones (the CL bound
    ‖γ‖₀ ≤ Q_G + Q_L that sizes the compact wire holds only then)."""
    gm = np.zeros((D,), np.float32)
    gm[r.choice(D, 5, replace=False)] = 1.0
    return gm


def _inputs(seed):
    r = np.random.default_rng(seed)
    c = [dict(g=r.standard_normal((K, D)).astype(np.float32),
              e=(0.1 * r.standard_normal((K, D))).astype(np.float32),
              w=r.uniform(0.5, 2.0, (K,)).astype(np.float32),
              p=(r.random((K,)) < 0.8).astype(np.float32),
              gm=_tcs_mask(r))
         for _ in range(B)]
    return {n: np.stack([x[n] for x in c]) for n in c[0]}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plans(form):
    """(port plan, reference plan) — shared chain or tree, or stacked."""
    chain, tree = K, AggTree(parent=PARENT)
    jchain, jtree = K, JTree(parent=tuple(JPS if p == PS else p
                                          for p in PARENT))
    if form != "stacked":
        topo, jtopo = (chain, jchain) if form == "chain" else (tree, jtree)
        return compile_plan(topo), jagg.compile_plan(jtopo)
    own = [compile_plan(t) for t in (chain, tree, chain)]
    jown = [jagg.compile_plan(t) for t in (jchain, jtree, jchain)]
    shape = (max(p.shape[0] for p in own) + 1,
             max(p.shape[1] for p in own) + 2)
    return (stack_plans([p.pad(shape) for p in own]),
            jagg.stack_plans([p.pad(shape) for p in jown]))


@functools.partial(jax.jit, static_argnums=0)
def _jexecute_batched(cfg, plan, g, e, w, gm, p):
    return jagg.execute_batched(cfg, plan, g, e, w, global_mask=gm,
                                participate=p)


def _same(a, b, msg=""):
    a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
    b = b.view(torch.int16) if b.dtype == torch.bfloat16 else b
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (msg, a.shape, b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _assert_result(want, got, err_rtol=None, msg=""):
    _same(want.aggregate, got.aggregate, msg)
    _same(want.e_new, got.e_new, msg)
    for name in ("nnz_out", "nnz_global", "nnz_local", "bits"):
        _same(getattr(want.stats, name), getattr(got.stats, name), msg)
    if err_rtol is None:
        _same(want.stats.err_sq, got.stats.err_sq, msg)
    else:
        np.testing.assert_allclose(np.asarray(want.stats.err_sq),
                                   np.asarray(got.stats.err_sq),
                                   rtol=err_rtol, atol=1e-5)


def _run(cfg, plan, x, dtype=torch.float32, **kw):
    args = (_t(x["g"]).to(dtype), _t(x["e"]).to(dtype), _t(x["w"]))
    opt = dict(global_mask=_t(x["gm"]).to(dtype), participate=_t(x["p"]))
    return (execute_batched(cfg, plan, *args, **opt),
            execute_sharded_batched(cfg, plan, *args, mesh=MESH, **opt,
                                    **kw))


@pytest.mark.parametrize("form", ["chain", "tree", "stacked"])
@pytest.mark.parametrize("kind", KINDS)
def test_execute_sharded_batched_matches_reference(kind, form):
    kw = dict(kind=kind, q=9, q_global=5, q_local=3)
    cfg, jcfg = AggConfig(**kw), JCfg(kernel_mode="ref", **kw)
    plan, jplan = _plans(form)
    x = _inputs(31)
    want = _jexecute_batched(jcfg, jplan, x["g"], x["e"], x["w"], x["gm"],
                             x["p"])
    host, got = _run(cfg, plan, x)
    _assert_result(jax.tree.map(np.asarray, want),
                   jax.tree.map(lambda t: t.numpy(), got), ERR_RTOL,
                   f"{kind}/{form} vs reference")
    _assert_result(host, got, None, f"{kind}/{form} vs host")


@pytest.mark.parametrize("form", ["chain", "tree", "stacked"])
@pytest.mark.parametrize("kind", KINDS)
def test_execute_sharded_batched_equals_host_unfused_and_bf16(kind, form):
    plan, _ = _plans(form)
    x = _inputs(17)
    cfg = AggConfig(kind=kind, q=9, q_global=5, q_local=3,
                    kernel_mode="never")
    _assert_result(*_run(cfg, plan, x), None, f"{kind}/{form} unfused")
    cfg = AggConfig(kind=kind, q=9, q_global=5, q_local=3)
    host, got = _run(cfg, plan, x, torch.bfloat16)
    assert got.aggregate.dtype == torch.bfloat16
    _assert_result(host, got, None, f"{kind}/{form} bf16")


@pytest.mark.parametrize("impl", ["scan", "hist"])
@pytest.mark.parametrize("kind", ["sia", "re_sia", "cl_sia", "tc_sia",
                                  "cl_tc_sia"])
def test_execute_sharded_batched_threshold_equals_host(kind, impl):
    cfg = AggConfig(kind=kind, q=9, q_global=5, q_local=3,
                    topq_impl="threshold", tau_impl=impl,
                    hist_rounds=3 if impl == "scan" else 2)
    plan, _ = _plans("stacked")
    _assert_result(*_run(cfg, plan, _inputs(13)), None, f"{kind}/{impl}")


@pytest.mark.parametrize("kind", ["cl_sia", "cl_tc_sia"])
def test_batched_compact_wire_equals_dense(kind):
    cfg = AggConfig(kind=kind, q=9, q_global=5, q_local=3)
    plan, _ = _plans("stacked")
    x = _inputs(5)
    args = (_t(x["g"]), _t(x["e"]), _t(x["w"]))
    rounds = [execute_sharded_batched(cfg, plan, *args, mesh=MESH,
                                      global_mask=_t(x["gm"]), wire=wire)
              for wire in ("compact", "dense")]
    _assert_result(*rounds, None, kind)
    host = execute_batched(cfg, plan, *args, global_mask=_t(x["gm"]))
    _assert_result(host, rounds[0], None, kind)


def test_execute_sharded_batched_rejects_mismatches():
    cfg = AggConfig(kind="sia", q=9)
    x = _inputs(0)
    chain = compile_plan(K)
    tree = compile_plan(AggTree(parent=PARENT))
    shape = tuple(np.maximum(chain.shape, tree.shape))
    two = stack_plans([chain.pad(shape), tree.pad(shape)])
    with pytest.raises(ValueError, match="2 cohorts"):
        execute_sharded_batched(cfg, two, _t(x["g"]), _t(x["e"]),
                                _t(x["w"]), mesh=MESH)
    with pytest.raises(ValueError, match="plan has 6 clients"):
        execute_sharded_batched(cfg, chain, _t(x["g"][:, :4]),
                                _t(x["e"][:, :4]), _t(x["w"][:, :4]),
                                mesh=MESH)


# ---------------------------------------------------------------------------
# Simulator.run_batched on the device backend
# ---------------------------------------------------------------------------

SIM_K = 6


@functools.lru_cache(maxsize=None)
def _fed():
    train = make_synthetic_mnist(0, SIM_K * 60, device="cpu")
    return partition_iid(train, SIM_K, torch.Generator().manual_seed(2))


@pytest.mark.parametrize("kind", ["cl_sia", "tc_sia"])
def test_run_batched_device_equals_host(kind):
    pc = dataclasses.replace(PAPER, num_clients=SIM_K)
    cfg = AggConfig(kind=kind, q=78)
    host = Simulator(pc, cfg, _fed(), device="cpu")
    dev = Simulator(pc, cfg, _fed(), device="cpu", backend="device",
                    mesh=client_mesh(SIM_K, devices=["cpu"] * SIM_K))

    def stragglers(r, state):
        p = np.ones((B, SIM_K), np.float32)
        p[r % B, (r + 2) % SIM_K] = 0.0
        return p

    runs = [sim.run_batched(5, seeds=(1, 2, 3), topology=star_tree(SIM_K),
                            participate_fn=stragglers)
            for sim in (host, dev)]
    a, b = runs
    assert a["loss"] == b["loss"] and a["bits"] == b["bits"]
    assert a["nnz"] == b["nnz"]
    _same(a["state"].flat_w, b["state"].flat_w)
    _same(a["state"].ef, b["state"].ef)
    with pytest.raises(ValueError, match="nested"):
        Simulator(pc, cfg, _fed(), device="cpu", backend="device",
                  mesh=dev.mesh,
                  nested_topology=[[((0, 1, 2), None), ((3, 4, 5), None)],
                                   [((0, 1), None)]]).run_batched(
                      1, seeds=(0,))
