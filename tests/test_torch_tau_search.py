"""Threshold Top-Q of the port against the JAX package: the τ search and
whole rounds under ``topq_impl="threshold"``.

The port of ``tests/test_tau_search.py``. Every case feeds the same numpy
arrays to the jitted JAX function and to its port and demands equality bit
for bit (tolerance: none) of τ, the per-round candidate-count integers,
the aggregate, the EF rows and the §V counts and bits; ``err_sq`` under
``err_sq_mode="jnp"`` is a row sum in XLA's order, held to rtol 1e-6.
Inside the port, as in the reference, the count-free shortcut equals the
counting scan, ``tau_impl="hist"`` equals the scan at the same rounds, and
the fused-operand search equals the materialized one. Branches are powers
of two, as in the reference's tests (for other branches the reference's
own shortcut and counting scan may differ in the last bit of τ).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.agg import plan as jplan
from repro.core import chain as jchain
from repro.core import sparsify as jsp
from repro.core.algorithms import AggConfig as JCfg
from repro.kernels import ops as jops
from repro.kernels import level as jlevel
from repro.kernels import ref as jref
from repro.topo.tree import PS, AggTree
from repro_torch import convert
from repro_torch.agg import plan as tplan
from repro_torch.core import chain as tchain
from repro_torch.core import sparsify as tsp
from repro_torch.core.algorithms import AggConfig as TCfg
from repro_torch.core.algorithms import AggKind, index_bits
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

KINDS = ["sia", "re_sia", "cl_sia", "tc_sia", "cl_tc_sia"]
K, D, Q = 7, 96, 11
TREE = dict(parent=(PS, 0, 1, 1, 3, 0, 5))
PART = np.array([1, 0, 1, 1, 0, 1, 1], np.float32)
ERR_RTOL = 1e-6


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _same(a, b, msg=""):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape, (msg, a.shape, b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _inputs(k=K, d=D, seed=0):
    rng = np.random.default_rng(seed)
    return dict(g=rng.standard_normal((k, d)).astype(np.float32),
                e=(0.1 * rng.standard_normal((k, d))).astype(np.float32),
                w=np.ones((k,), np.float32))


def _gmask(kind, cfg):
    if kind in ("tc_sia", "cl_tc_sia"):
        gm = np.zeros((D,), np.float32)
        gm[:cfg.q_global] = 1.0
        return gm
    return None


def _cfgs(kind, **kw):
    kw = dict(kind=kind, q=Q, topq_impl="threshold", **kw)
    return JCfg(**kw), TCfg(**kw)


def _rounds(jcfg, tcfg, jp, x, gm, part):
    j = jax.jit(functools.partial(jplan.execute, jcfg, global_mask=gm,
                                  participate=part))(jp, x["g"], x["e"],
                                                     x["w"])
    t = tplan.execute(tcfg, convert.agg_plan(jp),
                      *(_t(x[k]) for k in "gew"), global_mask=_t(gm),
                      participate=_t(part))
    return j, t


def _assert_round(j, t, msg, err_bitwise=False):
    _same(j.aggregate, t.aggregate, f"{msg}/aggregate")
    _same(j.e_new, t.e_new, f"{msg}/e_new")
    for name in ("nnz_out", "nnz_global", "nnz_local", "bits"):
        _same(getattr(j.stats, name), getattr(t.stats, name),
              f"{msg}/{name}")
    if err_bitwise:
        _same(j.stats.err_sq, t.stats.err_sq, f"{msg}/err_sq")
    else:
        np.testing.assert_allclose(np.asarray(j.stats.err_sq),
                                   t.stats.err_sq.numpy(), rtol=ERR_RTOL,
                                   err_msg=f"{msg}/err_sq")


def _assert_equal_values(a, b, msg):
    """Two port rounds equal as numbers (+0.0 == −0.0, as the reference's
    own fused-vs-unfused contract reads)."""
    for u, v in zip((a.aggregate, a.e_new) + tuple(a.stats[:4]),
                    (b.aggregate, b.e_new) + tuple(b.stats[:4])):
        assert torch.equal(u, v), msg


# ---------------------------------------------------------------------------
# the τ search on materialized operands
# ---------------------------------------------------------------------------

def _search_both(x, q, **kw):
    """(jax τ[, counts], port τ[, counts]) of one search."""
    j = jax.jit(functools.partial(jsp.threshold_for_topq, q=q, **kw))(x)
    t = tsp.threshold_for_topq(_t(x), q, **kw)
    return j, t


def test_default_scan_shortcut_matches_counting_scan():
    """The count-free shortcut gives the counting scan's τ — q ≤ 0,
    q ≥ d, an all-zero operand and ties included — and both give the
    reference's."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 3000)).astype(np.float32)
    ties = np.ones((512,), np.float32)
    ties[3] = 7.0
    cases = [(x, q) for q in (0, 1, 40, 3000, 5000)]
    cases += [(x[0], 40), (np.zeros((512,), np.float32), 5), (ties, 5)]
    for xx, q in cases:
        count_fn = tsp.count_ge_batch if xx.ndim == 2 else tsp.count_ge
        got = tsp.threshold_for_topq(_t(xx), q)
        want = tsp.threshold_for_topq(_t(xx), q, count_fn=count_fn)
        _same(want.numpy(), got, f"q={q} shape={xx.shape}")
        j, _ = _search_both(xx, q)
        _same(j, got, f"reference q={q} shape={xx.shape}")


def test_fused_count_cohort_gmask_parity():
    """Cohort-shared [B, d] global masks (the lanes of a multi-tenant
    batched round, cohort-major) through the fused count and the histogram:
    the port's plain versions equal the jitted reference and its Pallas
    kernels in interpret mode. The Pallas histogram counts its lane padding
    in the never-read bin D2[·, 0, 0], which is zeroed on both sides."""
    b, lanes, d = 2, 3, 1000
    w_l = b * lanes
    x = _inputs(k=w_l, d=d, seed=5)
    rng = np.random.default_rng(6)
    g, e = x["g"], x["e"]
    gin = np.zeros_like(g)
    wv = p = np.ones((w_l,), np.float32)
    gm = (rng.random((b, d)) < 0.1).astype(np.float32)
    taus = np.sort(rng.random((w_l, 16)).astype(np.float32), axis=-1)
    args = (g, e, gin, wv, p)
    got = tops.count_ge_fused_level(*map(_t, args), _t(taus), _t(gm),
                                    gmask_cohorts=b)
    _same(jax.jit(functools.partial(jref.ref_count_ge_fused_level,
                                    gmask_cohorts=b))(*args, taus, gm), got)
    _same(jlevel.count_ge_fused_level_pallas(*args, taus, gm,
                                             gmask_cohorts=b,
                                             interpret=True), got)

    op = tref.fused_operand(*map(_t, args), _t(gm), gmask_cohorts=b)
    hi = op.abs().amax(-1) * np.float32(1 + 1e-6)
    tables = tsp._hist_tables(torch.zeros_like(hi),
                              torch.clamp(hi, min=1e-30), 64)
    d2, f = tops.hist_topq_level(*map(_t, args), tables, _t(gm),
                                 gmask_cohorts=b)
    jt = tuple(t.numpy() for t in tables)
    for want in (jax.jit(functools.partial(jref.ref_hist_topq_level,
                                           gmask_cohorts=b))(*args, jt, gm),
                 jlevel.hist_topq_level_pallas(*args, jt, gm,
                                               gmask_cohorts=b,
                                               interpret=True)):
        d2_w, d2_g = np.array(want[0]), d2.numpy().copy()
        d2_w[:, 0, 0] = d2_g[:, 0, 0] = 0
        np.testing.assert_array_equal(d2_w, d2_g)
        _same(want[1], f)


def _assert_hist_matches_scan(x, q, branch, rounds):
    kw = dict(branch=branch, rounds=rounds, with_counts=True)
    (tau_js, c_js), (tau_s, c_s) = _search_both(x, q, **kw)
    (tau_jh, c_jh), (tau_h, c_h) = _search_both(x, q, tau_impl="hist", **kw)
    msg = f"q={q} b={branch} r={rounds}"
    _same(tau_s.numpy(), tau_h, f"hist τ {msg}")
    _same(c_s.numpy(), c_h, f"hist counts {msg}")
    _same(tau_js, tau_s, f"scan τ vs reference {msg}")
    _same(c_js, c_s, f"scan counts vs reference {msg}")
    _same(tau_jh, tau_h, f"hist τ vs reference {msg}")
    _same(c_jh, c_h, f"hist counts vs reference {msg}")


@pytest.mark.parametrize("branch", [16, 64])
@pytest.mark.parametrize("rounds", [1, 2])
def test_hist_matches_scan_directed(branch, rounds):
    x = np.random.default_rng(12).standard_normal((4, 3000)).astype(
        np.float32)
    for q in (1, 40, 1000, 2999):
        _assert_hist_matches_scan(x, q, branch, rounds)
    ties = np.ones((512,), np.float32)
    ties[3] = 7.0
    _assert_hist_matches_scan(np.zeros((512,), np.float32), 5, branch,
                              rounds)
    _assert_hist_matches_scan(ties, 5, branch, rounds)


@pytest.mark.parametrize("seed", range(8))
def test_hist_matches_scan_seeded(seed):
    """Seeded cases in place of the reference's hypothesis property."""
    rng = np.random.default_rng(1000 + seed)
    d = int(rng.integers(2, 600))
    q = int(rng.integers(1, d + 1))
    branch = int(rng.choice([4, 16, 64, 256]))
    rounds = int(rng.integers(1, 3))
    scale = np.float32(rng.choice([1e-6, 1.0, 1e6]))
    x = (scale * rng.standard_normal((d,))).astype(np.float32)
    _assert_hist_matches_scan(x, q, branch, rounds)


def test_hist_validation():
    one = torch.ones((8,))
    with pytest.raises(ValueError, match="rounds must be 1 or 2"):
        tsp.threshold_for_topq(one, 2, rounds=3, tau_impl="hist")
    with pytest.raises(ValueError, match="branch"):
        tsp.threshold_for_topq(one, 2, rounds=2, branch=2048,
                               tau_impl="hist")
    with pytest.raises(ValueError, match="tau_impl"):
        tsp.threshold_for_topq(one, 2, tau_impl="histo")
    with pytest.raises(ValueError, match="at least one shard"):
        tsp.threshold_for_topq([], 2)
    with pytest.raises(ValueError, match="shards must all be"):
        tsp.threshold_for_topq([one, one[None]], 2)
    with pytest.raises(ValueError, match="hist_rounds"):
        TCfg(kind=AggKind.SIA, q=5, tau_impl="hist")      # hist_rounds=3
    with pytest.raises(ValueError, match="tau_impl"):
        TCfg(kind=AggKind.SIA, q=5, tau_impl="histo")
    with pytest.raises(ValueError, match="topq_impl"):
        TCfg(kind=AggKind.SIA, q=5, topq_impl="approx")


def test_topq_by_threshold_compact_scatter_match_reference():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((700,)).astype(np.float32)
    for impl, rounds in (("scan", 3), ("hist", 2)):
        j = jax.jit(functools.partial(jsp.topq_by_threshold, q=31,
                                      rounds=rounds, tau_impl=impl))(x)
        _same(j, tsp.topq_by_threshold(_t(x), 31, rounds=rounds,
                                       tau_impl=impl), impl)
    sparse = np.where(np.abs(x) > 2.0, x, 0).astype(np.float32)
    jv, ji, jc = jax.jit(jsp.compact, static_argnums=1)(sparse, 40)
    tv, ti, tc = tsp.compact(_t(sparse), 40)
    _same(jv, tv)
    _same(ji, ti)
    assert int(jc) == int(tc)
    _same(jax.jit(jsp.scatter, static_argnums=2)(jv, ji, 700),
          tsp.scatter(tv, ti, 700))


# ---------------------------------------------------------------------------
# the fused-operand search (count callbacks over the raw node inputs)
# ---------------------------------------------------------------------------

def test_operand_fn_tau_matches_materialized():
    """``threshold_for_topq(operand_fn=...)`` over the dispatched fused
    counts and histogram ≡ the materialized search ≡ the reference, for
    the full operand family (γ and global-mask factors on)."""
    w_l, d = 4, 300
    rng = np.random.default_rng(4)
    g = rng.standard_normal((w_l, d)).astype(np.float32)
    e = (0.1 * rng.standard_normal((w_l, d))).astype(np.float32)
    gin = (0.2 * rng.standard_normal((w_l, d))).astype(np.float32)
    wv = np.array([1.0, 0.5, 2.0, 1.0], np.float32)
    p = np.array([1, 1, 0, 1], np.float32)
    gm = np.zeros((d,), np.float32)
    gm[:40] = 1.0
    args = tuple(map(_t, (g, e, gin, wv, p)))
    x = tref.fused_operand(*args, _t(gm), include_gamma=True)
    op = tsp.TauOperand(
        count=lambda taus: tops.count_ge_fused_level(
            *args, taus, _t(gm), include_gamma=True),
        max_abs=lambda: x.abs().amax(-1), batched=True,
        hist=lambda tables: tops.hist_topq_level(
            *args, tables, _t(gm), include_gamma=True))
    jx = np.asarray(jax.jit(functools.partial(
        jref.fused_operand, include_gamma=True))(g, e, gin, wv, p, gm))
    _same(jx, x)
    for q in (3, 29, 250):
        for impl, rounds in (("scan", 3), ("scan", 2), ("hist", 2)):
            kw = dict(rounds=rounds, tau_impl=impl, with_counts=True)
            tau_m, c_m = tsp.threshold_for_topq(x, q, **kw)
            tau_f, c_f = tsp.threshold_for_topq(None, q, operand_fn=op,
                                                **kw)
            msg = f"q={q}/{impl}/{rounds}"
            _same(tau_m.numpy(), tau_f, msg)
            _same(c_m.numpy(), c_f, msg)
            j_op = jsp.TauOperand(
                count=lambda taus: jops.count_ge_fused_level(
                    g, e, gin, wv, p, taus, gm, include_gamma=True,
                    mode="never"),
                max_abs=lambda: np.abs(jx).max(-1), batched=True,
                hist=lambda tables: jops.hist_topq_level(
                    g, e, gin, wv, p, tables, gm, include_gamma=True,
                    mode="never"))
            tau_j, c_j = jax.jit(lambda: jsp.threshold_for_topq(
                None, q, operand_fn=j_op, **kw))()
            _same(tau_j, tau_f, f"reference {msg}")
            _same(c_j, c_f, f"reference {msg}")


# ---------------------------------------------------------------------------
# whole rounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["ref", "never"])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_operand_round_parity(kind, mode):
    """Each mode equals the reference's same mode; the fused structure
    equals the unfused bodies (as numbers), on the chain and a padded
    tree, with and without stragglers."""
    jcfg, tcfg = _cfgs(kind, kernel_mode=mode)
    other = dataclasses.replace(tcfg, kernel_mode="never" if mode == "ref"
                                else "ref")
    x = _inputs(seed=2)
    gm = _gmask(kind, tcfg)
    for name, topo, pad in [("chain", K, None),
                            ("tree", AggTree(**TREE), (K, 4))]:
        jp = jplan.compile_plan(topo, pad_to=pad)
        for pname, part in [("all", None), ("stragglers", PART)]:
            msg = f"{kind}/{mode}/{name}/{pname}"
            j, t = _rounds(jcfg, tcfg, jp, x, gm, part)
            _assert_round(j, t, msg)
            t2 = tplan.execute(other, convert.agg_plan(jp),
                               *(_t(x[k]) for k in "gew"),
                               global_mask=_t(gm), participate=_t(part))
            _assert_equal_values(t, t2, msg)


@pytest.mark.parametrize("kind", KINDS)
def test_fused_operand_round_parity_q_budget(kind):
    """Dynamic per-node budgets sort the materialized operand; the rounds
    still equal the reference's, fused and unfused."""
    x = _inputs(seed=3)
    qb = np.asarray([5, 3, 5, 2, 5, 1, 4], np.int32)
    jp = jplan.compile_plan(AggTree(**TREE), q_budget=qb, pad_to=(K, 3))
    for mode in ("ref", "never"):
        jcfg, tcfg = _cfgs(kind, kernel_mode=mode)
        j, t = _rounds(jcfg, tcfg, jp, x, _gmask(kind, tcfg), None)
        _assert_round(j, t, f"{kind}/{mode}/q_budget")


@pytest.mark.parametrize("kind", KINDS)
def test_hist_round_parity_all_kinds(kind):
    """Whole rounds under tau_impl='hist' ≡ the scan at the same rounds ≡
    the reference, materialized and fused-operand structures alike."""
    x = _inputs(seed=13)
    jp = jplan.compile_plan(AggTree(**TREE), pad_to=(K, 4))
    for kmode in ("never", "ref"):
        js, ts = _cfgs(kind, kernel_mode=kmode, hist_rounds=2)
        jh, th = (dataclasses.replace(c, tau_impl="hist") for c in (js, ts))
        gm = _gmask(kind, ts)
        j_s, t_s = _rounds(js, ts, jp, x, gm, None)
        j_h, t_h = _rounds(jh, th, jp, x, gm, None)
        msg = f"{kind}/{kmode}"
        _assert_round(j_s, t_s, f"{msg}/scan")
        _assert_round(j_h, t_h, f"{msg}/hist")
        for u, v in zip((t_s.aggregate, t_s.e_new) + tuple(t_s.stats[:4]),
                        (t_h.aggregate, t_h.e_new) + tuple(t_h.stats[:4])):
            _same(u.numpy(), v, f"{msg}/hist vs scan")


def test_threshold_bits_charge_realized_nnz_hist():
    """§V under the hist bisection: ≥ q survivors, and the bits charge the
    realized support, not q — as in the reference's run."""
    jcfg, tcfg = _cfgs("cl_sia", tau_impl="hist", hist_rounds=2)
    x = _inputs(seed=14)
    res = tchain.run_chain(tcfg, *(_t(x[k]) for k in "gew"))
    nnz = res.stats.nnz_out.numpy()
    assert (nnz >= Q).all(), nnz
    word = tcfg.omega + index_bits(D)
    np.testing.assert_array_equal(res.stats.bits.numpy(),
                                  (word * nnz).astype(np.float32))
    j = jax.jit(lambda g, e, w: jchain.run_chain(jcfg, g, e, w))(
        x["g"], x["e"], x["w"])
    _assert_round(j, res, "run_chain")


@pytest.mark.parametrize("kind", KINDS)
def test_err_sq_mode_kernel_under_threshold(kind):
    """err_sq_mode='kernel' leaves every §V output of a threshold round
    unchanged, and its pinned ‖e′‖² equals the reference's bit for bit."""
    x = _inputs(seed=18)
    jp = jplan.compile_plan(AggTree(**TREE), pad_to=(K, 4))
    jcfg, tcfg = _cfgs(kind, kernel_mode="ref", err_sq_mode="kernel")
    gm = _gmask(kind, tcfg)
    j, t = _rounds(jcfg, tcfg, jp, x, gm, PART)
    _assert_round(j, t, f"{kind}/kernel", err_bitwise=True)
    base = tplan.execute(dataclasses.replace(tcfg, err_sq_mode="jnp"),
                         convert.agg_plan(jp), *(_t(x[k]) for k in "gew"),
                         global_mask=_t(gm), participate=_t(PART))
    for u, v in zip((t.aggregate, t.e_new) + tuple(t.stats[:4]),
                    (base.aggregate, base.e_new) + tuple(base.stats[:4])):
        _same(u.numpy(), v, f"{kind}/kernel vs jnp")
    np.testing.assert_allclose(t.stats.err_sq.numpy(),
                               base.stats.err_sq.numpy(), rtol=ERR_RTOL)


# ---------------------------------------------------------------------------
# the sharded τ search (the reference's ``axis_name``)
# ---------------------------------------------------------------------------

SHARDS = 8
# (name, rows (0: 1-D), d, q, tau_impl, rounds)
SHARDED = [("scan 1-D q=50", 0, SHARDS * 1000, 50, "scan", 3),
           ("scan 1-D q=700", 0, SHARDS * 1000 + 8, 700, "scan", 3),
           ("hist 1-D q=50", 0, SHARDS * 1000, 50, "hist", 2),
           ("scan [3, d]", 3, SHARDS * 400, 37, "scan", 3),
           ("hist [3, d]", 3, SHARDS * 400, 37, "hist", 2)]

SHARDED_REFERENCE = r"""
import json, functools
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core import sparsify as sp

inp = dict(np.load(INPUTS))
mesh = compat.make_mesh((8,), ("data",))
out = {}
for name, rows, d, q, impl, rounds in json.loads(CASES):
    x = inp[name]                       # [8, d/8] or [8, rows, d/8]

    def body(x_l):
        tau, counts = sp.threshold_for_topq(
            x_l[0], q, branch=64, rounds=rounds, axis_name="data",
            tau_impl=impl, with_counts=True)
        return tau[None], counts[None]

    tau, counts = jax.jit(compat.shard_map(
        body, mesh=mesh, in_specs=(P("data"),),
        out_specs=(P("data"), P("data")), axis_names={"data"}))(x)
    out[name + "/tau"] = np.asarray(tau)
    out[name + "/counts"] = np.asarray(counts)
np.savez(OUTPUTS, **out)
print("PASS")
"""


def _sharded_input(rows, d, seed):
    rng = np.random.default_rng(seed)
    shape = (rows, d) if rows else (d,)
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[::97] = 0.0                      # zeros and ties
    x.reshape(-1)[5::211] = 1.5
    return x


def _shards(x):
    """Per-rank pieces of the last axis, as the reference's mesh splits it
    (``[8, d/8]`` → 8 × ``[d/8]``; rows keep their lane axis)."""
    return [torch.from_numpy(np.ascontiguousarray(p))
            for p in np.split(x, SHARDS, axis=-1)]


@pytest.fixture(scope="module")
def sharded_reference(tmp_path_factory, multidev):
    import json
    d = tmp_path_factory.mktemp("tau_sharded")
    arrays = {}
    for i, (name, rows, dd, q, impl, rounds) in enumerate(SHARDED):
        x = _sharded_input(rows, dd, 300 + i)
        arrays[name] = np.stack(np.split(x, SHARDS, axis=-1))
    np.savez(d / "in.npz", **arrays)
    multidev(f"INPUTS = {str(d / 'in.npz')!r}\n"
             f"OUTPUTS = {str(d / 'out.npz')!r}\n"
             f"CASES = {json.dumps(SHARDED)!r}\n" + SHARDED_REFERENCE,
             devices=SHARDS)
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("case", SHARDED, ids=[c[0] for c in SHARDED])
@pytest.mark.parametrize("count", ["sorted", "count_ge"])
def test_sharded_search_equals_the_unsharded_search(case, count):
    """τ and every round's counts of the search over 8 shards (each
    counting its own elements, here through ``ops.count_ge`` /
    ``ops.count_ge_level`` when asked) equal the search over the whole
    vector; the τ also equals the count-free shortcut's."""
    i = SHARDED.index(case)
    name, rows, d, q, impl, rounds = case
    x = _sharded_input(rows, d, 300 + i)
    count_fn = (None if count == "sorted"
                else tops.count_ge_level if rows else tops.count_ge)
    kw = dict(branch=64, rounds=rounds, tau_impl=impl)
    tau, counts = tsp.threshold_for_topq(_shards(x), q, count_fn=count_fn,
                                         with_counts=True, **kw)
    tau_1, counts_1 = tsp.threshold_for_topq(_t(x), q, with_counts=True,
                                             **kw)
    _same(tau_1.numpy(), tau, name)
    _same(counts_1.numpy(), counts, name + " counts")
    _same(tau_1.numpy(), tsp.threshold_for_topq(_shards(x), q,
                                                count_fn=count_fn, **kw),
          name + " without counts")
    if impl == "scan":
        _same(tau_1.numpy(), tsp.threshold_for_topq(_t(x), q, **kw),
              name + " shortcut")


@pytest.mark.parametrize("case", SHARDED, ids=[c[0] for c in SHARDED])
def test_sharded_search_matches_the_reference_axis_name(sharded_reference,
                                                        case):
    """The reference's ``threshold_for_topq(axis_name=)`` on 8 fake devices
    with ``with_counts=True``: every rank's τ and counts equal the port's
    sharded search bit for bit."""
    i = SHARDED.index(case)
    name, rows, d, q, impl, rounds = case
    x = _sharded_input(rows, d, 300 + i)
    tau, counts = tsp.threshold_for_topq(
        _shards(x), q, branch=64, rounds=rounds, tau_impl=impl,
        with_counts=True)
    for r in range(SHARDS):
        _same(sharded_reference[name + "/tau"][r], tau, f"{name} rank {r}")
        _same(sharded_reference[name + "/counts"][r], counts,
              f"{name} rank {r} counts")
