"""``level_step`` and ``node_step`` of the port against the JAX package.

Same numpy inputs into both; the JAX side runs under ``jax.jit`` (where
XLA contracts ``a*b + c`` into fused multiply-adds, which the port
reproduces). Tolerances: none — bit for bit — on γ_out, e′, every
integer count and the f32 bits; ``err_sq`` under ``err_sq_mode="jnp"`` is
a plain row sum whose order is XLA's choice, held to rtol 1e-6 (see
``ERR_RTOL``); under ``err_sq_mode="kernel"`` it is the pinned fold and
bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import algorithms as jalg
from repro_torch.core import algorithms as talg

torch.set_num_threads(1)

W, D, Q = 5, 700, 31
KINDS = ["sia", "re_sia", "cl_sia", "tc_sia", "cl_tc_sia", "dense_ia"]
# summation order only: XLA's vectorized row sum against torch's cascade
ERR_RTOL = 1e-6


def _inputs(seed=0, per_lane_mask=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    gm = ((rng.random((W, D)) if per_lane_mask else rng.random(D)) < 0.1)
    return dict(
        g=f(W, D) * 0.05,
        gam=(f(W, D) * (rng.random((W, D)) < 0.2)).astype(np.float32),
        e=f(W, D) * 0.01,
        w=rng.uniform(0.2, 2.0, W).astype(np.float32),
        p=np.array([1, 0, 1, 1, 1], np.float32),
        gm=gm.astype(np.float32),
        qb=np.array([3, 50, 0, D, 12], np.int32),
        valid=np.array([1, 1, 1, 1, 0], np.float32))


def _same(a, b):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


def _assert_round(j, t, err_bitwise):
    jg, je, js = j
    tg, te, ts = t
    _same(jg, tg)
    _same(je, te)
    for name in ("nnz_out", "nnz_global", "nnz_local", "bits"):
        _same(getattr(js, name), getattr(ts, name))
    if err_bitwise:
        _same(js.err_sq, ts.err_sq)
    else:
        np.testing.assert_allclose(np.asarray(js.err_sq), ts.err_sq.numpy(),
                                   rtol=ERR_RTOL, atol=0)


def _cfgs(kind, mode, err_sq_mode="jnp"):
    # each mode against the same mode of the reference: off-TPU its "ref"
    # is the fused structure with plain bodies, its "never" the unfused
    # bodies (the two differ in the sign of some zeros, so they are not
    # interchangeable under a bitwise comparison)
    kw = dict(kind=kind, q=Q, err_sq_mode=err_sq_mode, kernel_mode=mode)
    return jalg.AggConfig(**kw), talg.AggConfig(**kw)


def _run_both(kind, mode, x, *, budget, err_sq_mode="jnp"):
    jcfg, tcfg = _cfgs(kind, mode, err_sq_mode)
    qb = x["qb"] if budget else None
    args = [x[k] for k in ("g", "gam", "e", "w", "p", "gm")]
    j = jax.jit(jalg.level_step(jcfg))(*args, qb, x["valid"])
    t = talg.level_step(tcfg)(*(torch.from_numpy(a) for a in args),
                              None if qb is None else torch.from_numpy(qb),
                              torch.from_numpy(x["valid"]))
    return j, t


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["ref", "never"])
@pytest.mark.parametrize("budget", [False, True])
def test_level_step_matches_reference(kind, mode, budget):
    x = _inputs()
    j, t = _run_both(kind, mode, x, budget=budget)
    _assert_round(j, t, err_bitwise=False)


@pytest.mark.parametrize("kind", ["tc_sia", "cl_tc_sia"])
@pytest.mark.parametrize("mode", ["ref", "never"])
def test_level_step_per_lane_global_mask(kind, mode):
    x = _inputs(seed=1, per_lane_mask=True)
    j, t = _run_both(kind, mode, x, budget=False)
    _assert_round(j, t, err_bitwise=False)


@pytest.mark.parametrize("kind", ["sia", "re_sia", "cl_sia", "tc_sia",
                                  "cl_tc_sia"])
def test_level_step_pinned_err_is_bitwise(kind):
    x = _inputs(seed=2)
    j, t = _run_both(kind, "ref", x, budget=False, err_sq_mode="kernel")
    _assert_round(j, t, err_bitwise=True)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["ref", "never"])
def test_node_step_matches_reference(kind, mode):
    x = _inputs(seed=3)
    jcfg, tcfg = _cfgs(kind, mode)
    for lane in (0, 1):          # a participant and a straggler
        a = [x[k][lane] for k in ("g", "gam", "e", "w")]
        j = jax.jit(lambda g, gam, e, w, p, gm: jalg.node_step(jcfg)(
            jcfg, g, gam, e, w, jalg.NodeCtx(global_mask=gm,
                                             participate=p)))(
            *a, x["p"][lane], x["gm"])
        ctx = talg.NodeCtx(global_mask=torch.from_numpy(x["gm"]),
                           participate=torch.tensor(x["p"][lane]))
        t = talg.node_step(tcfg)(tcfg, *map(torch.from_numpy, a[:3]),
                                 torch.tensor(a[3]), ctx)
        _assert_round(j, t, err_bitwise=False)


def test_fused_and_unfused_agree_in_value():
    # equal as numbers (torch.equal: -0.0 == +0.0), as in the reference
    x = _inputs(seed=4)
    args = [torch.from_numpy(x[k]) for k in ("g", "gam", "e", "w", "p",
                                              "gm", "qb", "valid")]
    for kind in KINDS:
        a = talg.level_step(talg.AggConfig(kind=kind, q=Q,
                                           kernel_mode="ref"))(*args)
        b = talg.level_step(talg.AggConfig(kind=kind, q=Q,
                                           kernel_mode="never"))(*args)
        for u, v in zip(a[:2] + tuple(a[2][:4]), b[:2] + tuple(b[2][:4])):
            assert torch.equal(u, v), kind


def test_config_validation_and_unported_options():
    cfg = talg.AggConfig(kind=talg.AggKind.TC_SIA, q=78)
    ref = jalg.AggConfig(kind=jalg.AggKind.TC_SIA, q=78)
    assert (cfg.q_global, cfg.q_local) == (ref.q_global, ref.q_local)
    assert talg.index_bits(7850) == jalg.index_bits(7850)
    thr = talg.AggConfig(topq_impl="threshold", tau_impl="hist",
                         hist_rounds=2)
    ref_thr = jalg.AggConfig(topq_impl="threshold", tau_impl="hist",
                             hist_rounds=2)
    assert (thr.hist_branch, thr.hist_rounds) == (ref_thr.hist_branch,
                                                  ref_thr.hist_rounds)
    with pytest.raises(ValueError, match="hist_rounds"):
        talg.AggConfig(tau_impl="hist")
    with pytest.raises(ValueError):
        talg.AggConfig(topq_impl="approximate")
    with pytest.raises(ValueError):
        talg.AggConfig(kernel_mode="sometimes")
    with pytest.raises(ValueError):
        talg.AggConfig(err_sq_mode="exact")
    with pytest.raises(ValueError):
        talg.node_step(talg.AggConfig(kind=talg.AggKind.ROUTING))
    assert not talg.fused_node_steps(
        talg.AggConfig(kernel_mode="never"))
    assert talg.fused_node_steps(talg.AggConfig(kernel_mode="auto"))
    bf = torch.zeros(3, dtype=torch.bfloat16)
    assert not talg.fused_node_steps(talg.AggConfig(), bf, bf)


def test_error_feedback_helpers_match_reference():
    from repro.core import error_feedback as jef
    from repro_torch.core import error_feedback as tef
    x = _inputs(seed=5)
    g, e = x["g"][0], x["e"][0]
    _same(jax.jit(jef.apply_feedback)(g, e, np.float32(0.37)),
          tef.apply_feedback(torch.from_numpy(g), torch.from_numpy(e),
                             0.37))
    keep = np.array([True, False, True, True, False])
    jst = jef.rescale_clients(jef.EFState(e=x["e"]), keep)
    tst = tef.rescale_clients(tef.EFState(e=torch.from_numpy(x["e"])),
                              torch.from_numpy(keep))
    _same(jst.e, tst.e)
    np.testing.assert_allclose(float(jef.total_banked(jst)),
                               float(tef.total_banked(tst)), rtol=1e-6)
    assert tef.init_ef(3, 7, device="cpu").e.shape == (3, 7)
    assert tst.dim == D
    assert tef.init_ef_rank(7, device="cpu").e.shape == (7,)
    _same(jef.residual(g, e), tef.residual(torch.from_numpy(g),
                                           torch.from_numpy(e)))
