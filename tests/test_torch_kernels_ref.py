"""Plain PyTorch versions of the level kernels against the JAX package.

Each plain version (``repro_torch.kernels.ref``) is held bit for bit
(tolerance: none) against the Pallas kernel it stands for, run in interpret
mode on the CPU, and against ``repro.kernels.ref`` under ``jax.jit``, over
every variant the chip smoke sweeps: global mask none / lane-shared [d] /
per-lane [W, d] / cohort-shared [B, d] (``gmask_cohorts=2``: two cohorts of
two cohort-major lanes), mask_in on and off, the pinned ‖e′‖² on and off, a
``valid == 0`` lane, a ``p == 0`` lane and a τ = +inf lane, at a ragged
d = 2·8192 + 77 (two full 8×1024 tiles and a partial one). The τ-search
counts and the digit histogram are held the same way, over γ_in on and
off and the four global-mask forms; the Pallas kernels pad each row with
zeros to whole tiles, and their histogram counts that padding in the bin
``D2[w, 0, 0]`` (which the bisection never reads), so that one bin is left
out of the comparison with them and only there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import level as jlevel
from repro.kernels import ref as jref
from repro_torch.core import sparsify as tsp
from repro_torch.kernels import level as tlevel
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

W, D = 4, 2 * 8192 + 77
COHORTS = 2          # the cohort-shared mask: lanes 0-1 and 2-3


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        g=f(W, D), e=f(W, D) * 0.3,
        gin=(f(W, D) * (rng.random((W, D)) < 0.3)).astype(np.float32),
        weight=np.array([0.37, 1.3, 0.71, 2.2], np.float32),
        tau=np.array([1.0, 0.5, np.inf, 1.5], np.float32),
        part=np.array([1, 0, 1, 1], np.float32),
        valid=np.array([1, 1, 1, 0], np.float32),
        gm=(rng.random(D) < 0.1).astype(np.float32),
        gmw=(rng.random((W, D)) < 0.1).astype(np.float32),
        mask=(rng.random((W, D)) < 0.05).astype(np.float32),
        gmc=(rng.random((COHORTS, D)) < 0.1).astype(np.float32))


def _same(a, b):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


GMASKS = [None, "gm", "gmw", "gmc"]


def _cohorts(gm):
    return COHORTS if gm == "gmc" else 0


@pytest.mark.parametrize("gm", GMASKS)
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("with_err", [False, True])
def test_cl_fuse_level_plain_matches_pallas_and_ref(x, gm, with_mask,
                                                    with_err):
    gmask = x[gm] if gm else None
    mask = x["mask"] if with_mask else None
    args = (x["g"], x["e"], x["gin"], x["weight"], x["tau"], x["part"],
            x["valid"])
    c = _cohorts(gm)
    pallas = jlevel.cl_fuse_level_pallas(
        *args, None if gmask is None else jnp.asarray(gmask),
        None if mask is None else jnp.asarray(mask), gmask_cohorts=c,
        with_err=with_err, interpret=True)
    jitted = jax.jit(lambda *a: jref.ref_cl_fuse_level(
        *a, gmask_cohorts=c, with_err=with_err))(*args, gmask, mask)
    got = tref.ref_cl_fuse_level(*map(_t, args), _t(gmask), _t(mask),
                                 gmask_cohorts=c, with_err=with_err)
    assert len(got) == len(pallas) == 4 + with_err
    for p, j, t in zip(pallas, jitted, got):
        _same(p, t)
        _same(j, t)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("with_err", [False, True])
def test_sparsify_ef_level_plain_matches_pallas_and_ref(x, with_mask,
                                                        with_err):
    mask = x["mask"] if with_mask else None
    pallas = jlevel.sparsify_ef_level_pallas(
        x["g"], x["e"], None if mask is None else jnp.asarray(mask),
        x["weight"], x["tau"], x["valid"], with_err=with_err,
        interpret=True)
    jitted = jax.jit(lambda *a: jref.ref_sparsify_ef_level(
        *a, with_err=with_err))(x["g"], x["e"], mask, x["weight"], x["tau"],
                                x["valid"])
    got = tref.ref_sparsify_ef_level(
        _t(x["g"]), _t(x["e"]), _t(mask), _t(x["weight"]), _t(x["tau"]),
        _t(x["valid"]), with_err=with_err)
    assert len(got) == len(pallas) == 3 + with_err
    for p, j, t in zip(pallas, jitted, got):
        _same(p, t)
        _same(j, t)


@pytest.mark.parametrize("gm", GMASKS)
def test_chain_accum_level_plain_matches_pallas_and_ref(x, gm):
    gmask = x[gm] if gm else None
    c = _cohorts(gm)
    pallas = jlevel.chain_accum_level_pallas(
        x["gin"], x["g"], x["valid"],
        None if gmask is None else jnp.asarray(gmask), gmask_cohorts=c,
        interpret=True)
    jitted = jax.jit(lambda *a: jref.ref_chain_accum_level(
        *a, gmask_cohorts=c))(x["gin"], x["g"], x["valid"], gmask)
    got = tref.ref_chain_accum_level(_t(x["gin"]), _t(x["g"]),
                                     _t(x["valid"]), _t(gmask),
                                     gmask_cohorts=c)
    for p, j, t in zip(pallas, jitted, got):
        _same(p, t)
        _same(j, t)


@pytest.mark.parametrize("gm", GMASKS)
@pytest.mark.parametrize("include_gamma", [False, True])
def test_fused_operand_matches_ref(x, gm, include_gamma):
    gmask = x[gm] if gm else None
    c = _cohorts(gm)
    want = jax.jit(lambda *a: jref.fused_operand(
        *a, include_gamma=include_gamma, gmask_cohorts=c))(
            x["g"], x["e"], x["gin"], x["weight"], x["part"], gmask)
    got = tref.fused_operand(_t(x["g"]), _t(x["e"]), _t(x["gin"]),
                             _t(x["weight"]), _t(x["part"]), _t(gmask),
                             include_gamma=include_gamma, gmask_cohorts=c)
    _same(want, got)


def test_pinned_err_fold_matches_ref_tile_by_tile():
    # many single-tile lanes over a wide dynamic range: each lane's value
    # is one tile's fold, so any change of rounding in the fold shows
    rng = np.random.default_rng(4)
    e = (rng.standard_normal((64, 8192))
         * np.exp(rng.uniform(-4, 4, (64, 8192)))).astype(np.float32)
    _same(jax.jit(jref.ref_err_sq_level)(e), tref.ref_err_sq_level(_t(e)))


def test_ops_run_plain_versions_on_cpu_tensors(x):
    before = [k.launches for k in tlevel.KERNELS]
    args = [_t(x[k]) for k in ("gin", "g", "valid")]
    for mode in ("auto", "ref"):
        got = tops.chain_accum_level(*args, mode=mode)
        for a, b in zip(tref.ref_chain_accum_level(*args), got):
            assert torch.equal(a, b)
    # "always" asks for the kernel: on a CPU tensor it raises rather than
    # run the plain version
    with pytest.raises(RuntimeError, match="always"):
        tops.chain_accum_level(*args, mode="always")
    assert [k.launches for k in tlevel.KERNELS] == before
    assert tops.resolve("auto", torch.device("cpu")) == (True, False)
    assert tops.resolve("auto", torch.device("cuda")) == (True, True)
    assert tops.resolve("never", torch.device("cuda")) == (False, False)
    assert tops.resolve("ref", torch.device("cuda")) == (True, False)
    with pytest.raises(ValueError):
        tops.resolve("sometimes", torch.device("cpu"))


def test_cohort_gmask_runs_the_plain_versions(x):
    """The ``ops`` entries take a cohort-shared mask on CPU tensors
    through the plain versions: each cohort's lanes get what the
    lane-shared call with that cohort's [d] row gives, and a mask whose
    cohorts do not divide the lanes raises the reference's ValueError."""
    before = [k.launches for k in tlevel.KERNELS]
    args = [_t(x[k]) for k in ("gin", "g", "valid")]
    gmc = _t(x["gmc"])
    got = tops.chain_accum_level(*args, gmc, gmask_cohorts=COHORTS)
    lanes = W // COHORTS
    for b in range(COHORTS):
        rows = slice(b * lanes, (b + 1) * lanes)
        want = tops.chain_accum_level(*(a[rows] for a in args), gmc[b])
        for u, v in zip(want, got):
            assert torch.equal(u, v[rows])
    with pytest.raises(ValueError, match="incompatible"):
        tops.chain_accum_level(*args, _t(x["gmw"][:3]), gmask_cohorts=3)
    with pytest.raises(ValueError, match="incompatible"):
        tops.chain_accum_level(*args, gmc, gmask_cohorts=1)
    assert [k.launches for k in tlevel.KERNELS] == before


# ---------------------------------------------------------------------------
# τ search: counts and the joint digit histogram
# ---------------------------------------------------------------------------

def _tables(op: torch.Tensor, branch: int):
    """The bracket tables of a first τ-search round over ``op``."""
    hi = torch.clamp(op.abs().amax(-1), min=1e-30) * tsp._HI_SCALE
    return tsp._hist_tables(torch.zeros_like(hi), hi, branch)


def _operand_args(x):
    return (x["g"], x["e"], x["gin"], x["weight"], x["part"])


def _without_pad_bin(d2):
    d2 = np.array(d2)
    d2[:, 0, 0] = 0
    return d2


@pytest.mark.parametrize("gm", GMASKS)
@pytest.mark.parametrize("include_gamma", [False, True])
def test_count_ge_fused_level_plain_matches_pallas_and_ref(x, gm,
                                                           include_gamma):
    gmask = x[gm] if gm else None
    c = _cohorts(gm)
    args = _operand_args(x)
    op = tref.fused_operand(*map(_t, args), _t(gmask),
                            include_gamma=include_gamma, gmask_cohorts=c)
    taus = _tables(op, 64)[0].numpy()            # nondecreasing per lane
    taus[:, :3] = 0.0                            # counts every real element
    got = tref.ref_count_ge_fused_level(*map(_t, args), _t(taus),
                                        _t(gmask),
                                        include_gamma=include_gamma,
                                        gmask_cohorts=c)
    jitted = jax.jit(lambda *a: jref.ref_count_ge_fused_level(
        *a, include_gamma=include_gamma, gmask_cohorts=c))(*args, taus,
                                                           gmask)
    pallas = jlevel.count_ge_fused_level_pallas(
        *args, taus, None if gmask is None else jnp.asarray(gmask),
        include_gamma=include_gamma, gmask_cohorts=c, interpret=True)
    _same(jitted, got)
    _same(pallas, got)
    assert (got[:, 0].numpy() == D).all()


def test_count_ge_level_plain_matches_pallas_and_ref(x):
    """Taus in any order (ties, 0, ±inf) over a materialized operand."""
    rng = np.random.default_rng(6)
    taus = np.abs(rng.standard_normal((W, 48))).astype(np.float32)
    taus[:, 5] = taus[:, 9]
    taus[:, 7], taus[:, 8], taus[:, 11] = np.inf, -np.inf, 0.0
    xs = np.array(x["g"])
    xs[1, 4] = np.inf
    got = tref.ref_count_ge_level(_t(xs), _t(taus))
    _same(jax.jit(jref.ref_count_ge_level)(xs, taus), got)
    _same(jlevel.count_ge_level_pallas(xs, taus, interpret=True), got)


@pytest.mark.parametrize("gm", GMASKS)
@pytest.mark.parametrize("include_gamma", [False, True])
def test_hist_topq_level_plain_matches_pallas_and_ref(x, gm, include_gamma):
    gmask = x[gm] if gm else None
    c = _cohorts(gm)
    args = _operand_args(x)
    op = tref.fused_operand(*map(_t, args), _t(gmask),
                            include_gamma=include_gamma, gmask_cohorts=c)
    tables = _tables(op, 64)
    got = tref.ref_hist_topq_level(*map(_t, args), tables, _t(gmask),
                                   include_gamma=include_gamma,
                                   gmask_cohorts=c)
    jt = tuple(t.numpy() for t in tables)
    jitted = jax.jit(lambda *a: jref.ref_hist_topq_level(
        *a, include_gamma=include_gamma, gmask_cohorts=c))(*args, jt, gmask)
    pallas = jlevel.hist_topq_level_pallas(
        *args, jt, None if gmask is None else jnp.asarray(gmask),
        include_gamma=include_gamma, gmask_cohorts=c, interpret=True)
    for j, t in zip(jitted, got):
        _same(j, t)
    _same(_without_pad_bin(pallas[0]),
          torch.from_numpy(_without_pad_bin(got[0])))
    _same(pallas[1], got[1])
    assert int(got[0].sum()) == W * D


def test_hist_boundary_magnitudes_need_the_fma_candidate():
    """Magnitudes on the FMA-rounded round-2 candidates, the round-1 edges
    and the bracket tops: the plain histogram equals the jitted reference
    and the Pallas kernel, and a candidate rounded as a separate multiply
    and add would bin some of them elsewhere."""
    w_l, d = 2, 3000
    rng = np.random.default_rng(8)
    g = rng.standard_normal((w_l, d)).astype(np.float32)
    tables = _tables(_t(g), 64)
    edge = tref.hist_edge_magnitudes(tables, 1500, seed=1).numpy()
    g[:, :1500] = edge * np.where(rng.random(edge.shape) < 0.5, -1, 1)
    # operand = fma(1, g, 0) = g exactly
    args = (g, np.zeros_like(g), None, np.ones(w_l, np.float32),
            np.ones(w_l, np.float32))
    got = tref.ref_hist_topq_level(*map(_t, args), tables)
    jt = tuple(t.numpy() for t in tables)
    jitted = jax.jit(jref.ref_hist_topq_level)(*args, jt)
    pallas = jlevel.hist_topq_level_pallas(*args, jt, interpret=True)
    for j, t in zip(jitted, got):
        _same(j, t)
    _same(_without_pad_bin(pallas[0]),
          torch.from_numpy(_without_pad_bin(got[0])))
    _same(pallas[1], got[1])
    split = tsp._fma
    try:
        tsp._fma = lambda a, b, c: a * b + c
        other = tref.ref_hist_topq_level(*map(_t, args), tables)
    finally:
        tsp._fma = split
    assert not torch.equal(other[0], got[0])


@pytest.mark.parametrize("mode", ["auto", "ref", "never"])
def test_tau_search_ops_run_plain_versions_on_cpu_tensors(x, mode):
    before = [k.launches for k in tlevel.KERNELS]
    args = tuple(map(_t, _operand_args(x)))
    gm = _t(x["gm"])
    tables = _tables(tref.fused_operand(*args, gm), 16)
    got = tops.hist_topq_level(*args, tables, gm, mode=mode)
    for a, b in zip(tref.ref_hist_topq_level(*args, tables, gm), got):
        assert torch.equal(a, b)
    assert torch.equal(
        tops.count_ge_fused_level(*args, tables[0], gm, mode=mode),
        tref.ref_count_ge_fused_level(*args, tables[0], gm))
    assert torch.equal(tops.count_ge_level(args[0], tables[0], mode=mode),
                       tref.ref_count_ge_level(args[0], tables[0]))
    with pytest.raises(RuntimeError, match="always"):
        tops.hist_topq_level(*args, tables, gm, mode="always")
    with pytest.raises(RuntimeError, match="always"):
        tops.count_ge_fused_level(*args, tables[0], gm, mode="always")
    with pytest.raises(RuntimeError, match="always"):
        tops.count_ge_level(args[0], tables[0], mode="always")
    # the cohort-shared [B, d] form: one [d] row per cohort of W / B lanes
    gmc = _t(x["gmc"])
    assert torch.equal(
        tops.count_ge_fused_level(*args, tables[0], gmc,
                                  gmask_cohorts=COHORTS, mode=mode),
        tref.ref_count_ge_fused_level(
            *args, tables[0], gmc.repeat_interleave(W // COHORTS, dim=0)))
    assert torch.equal(
        tops.count_ge_fused_level(*args, tables[0], gm[None],
                                  gmask_cohorts=1, mode=mode),
        tref.ref_count_ge_fused_level(*args, tables[0], gm))
    assert [k.launches for k in tlevel.KERNELS] == before
