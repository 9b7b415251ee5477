"""CUDA level kernels against their plain PyTorch versions.

Needs a CUDA card and nvcc: every test takes the ``cuda`` fixture, which
skips where there is no card. Run on the card with
``python -m pytest -m gpu tests/test_torch_gpu.py``. Each kernel must equal
its plain version run on the CPU on the same inputs, bit for bit, for every
float and integer output (the CPU version is the one the parity tests hold
against the JAX package). The τ-search kernels are held the same way, at
the histogram's shared-memory and global-atomics branches, on magnitudes
placed on the histogram's bin edges, on NaN, infinite, zero and subnormal
magnitudes, and on tables that the digit estimate cannot take;
``count_ge_level`` on lanes whose rank tables cover other ranges, float32
and bfloat16, B up to ``MAX_TAUS``. The scalar
``[d]`` kernels are held the same way in float32 and bfloat16, with their
scalars as numbers and as tensors on the card, on views that do not start
on a 16-byte boundary, with taus in any order, on the bucket edges of
``count_ge``'s rank table, through the ``ops`` entries under ``"always"``,
and against the W = 1 level kernels where the two compute the same
function. The four kernels that take a global mask are held the same way
in its cohort-shared ``[B, d]`` form (``gmask_cohorts=B``), with cohort
rows that do not start on a 16-byte boundary (b·d % 4 ≠ 0), straggler and
``valid == 0`` lanes, and a ``ValueError`` where B does not divide W.
The LM serving path (plain PyTorch, no kernel of its own) runs each SMOKE
architecture and one full-width phi4-mini layer on the card against the
CPU in float32. The dry run's predicted device peak of one full decode
cell is held to the card's within ±1 %. A train state placed by rank on a
mesh that mixes the card and the CPU keeps its pieces on their ranks'
devices and equals the same steps on ranks of the card. Phase 1 split
over ``model`` (tensor-parallel, or batch over model) on ranks of the card
equals the same split step on ranks of the CPU, and its columns equal the
whole-model gradient's. Serving split over ranks of the card (each cache
layout) equals the whole form on the card, and the dry run predicts a
split serving step's peak within ±1 %.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import sparsify as sp
from repro_torch.kernels import (chain_accum, level, ops, ref, sparsify_ef,
                                 topq_threshold)

from _torch_launches import level_launches, train_launches

pytestmark = pytest.mark.gpu

SHAPES = [(1, 7850), (3, 2 * 8192 + 77), (5, 3), (2, 8192)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _inputs(w, d, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    gin = f(w, d) * (rng.random((w, d)) < 0.3)
    tau = np.full(w, 1.0, np.float32)
    part = np.ones(w, np.float32)
    valid = np.ones(w, np.float32)
    if w > 1:
        part[1] = 0.0          # straggler lane
        tau[-1] = np.inf       # pure-mask lane
    if w > 2:
        valid[2] = 0.0         # padding lane
    return dict(g=f(w, d), e=f(w, d) * 0.3, gin=gin.astype(np.float32),
                weight=rng.uniform(0.2, 2.0, w).astype(np.float32),
                tau=tau, part=part, valid=valid,
                gm=(rng.random(d) < 0.1).astype(np.float32),
                gmw=(rng.random((w, d)) < 0.1).astype(np.float32),
                mask=(rng.random((w, d)) < 0.05).astype(np.float32))


def _same(a, b):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


def _both(x, dev):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t, t.to(dev)


@pytest.mark.parametrize("w,d", SHAPES)
@pytest.mark.parametrize("gm", [None, "shared", "lane"])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("with_err", [False, True])
def test_cl_fuse_level_kernel(cuda, w, d, gm, with_mask, with_err):
    x = _inputs(w, d)
    c = {k: _both(v, cuda) for k, v in x.items()}
    gmk = {None: None, "shared": "gm", "lane": "gmw"}[gm]
    pick = lambda i: [c[k][i] for k in ("g", "e", "gin", "weight", "tau",
                                        "part", "valid")]
    opt = lambda i: dict(gmask=c[gmk][i] if gmk else None,
                         mask_in=c["mask"][i] if with_mask else None)
    want = ref.ref_cl_fuse_level(*pick(0), **opt(0), with_err=with_err)
    n0 = level.cl_fuse_level_cuda.launches
    got = level.cl_fuse_level_cuda(*pick(1), **opt(1), with_err=with_err)
    torch.cuda.synchronize()
    assert level.cl_fuse_level_cuda.launches == n0 + 1
    for a, b in zip(want, got):
        _same(a, b)


@pytest.mark.parametrize("w,d", SHAPES)
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("with_err", [False, True])
def test_sparsify_ef_level_kernel(cuda, w, d, with_mask, with_err):
    x = _inputs(w, d, seed=1)
    c = {k: _both(v, cuda) for k, v in x.items()}
    args = lambda i: (c["g"][i], c["e"][i],
                      c["mask"][i] if with_mask else None, c["weight"][i],
                      c["tau"][i], c["valid"][i])
    want = ref.ref_sparsify_ef_level(*args(0), with_err=with_err)
    got = level.sparsify_ef_level_cuda(*args(1), with_err=with_err)
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        _same(a, b)


@pytest.mark.parametrize("w,d", SHAPES)
@pytest.mark.parametrize("gm", [None, "shared", "lane"])
def test_chain_accum_level_kernel(cuda, w, d, gm):
    x = _inputs(w, d, seed=2)
    c = {k: _both(v, cuda) for k, v in x.items()}
    gmk = {None: None, "shared": "gm", "lane": "gmw"}[gm]
    args = lambda i: (c["gin"][i], c["g"][i], c["valid"][i],
                      c[gmk][i] if gmk else None)
    want = ref.ref_chain_accum_level(*args(0))
    got = level.chain_accum_level_cuda(*args(1))
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        _same(a, b)


def test_ops_dispatch_follows_device(cuda):
    x = _inputs(2, 100)
    c = {k: _both(v, cuda) for k, v in x.items()}
    n0 = level.chain_accum_level_cuda.launches
    ops.chain_accum_level(c["gin"][1], c["g"][1], c["valid"][1])
    assert level.chain_accum_level_cuda.launches == n0 + 1
    ops.chain_accum_level(c["gin"][0], c["g"][0], c["valid"][0])
    ops.chain_accum_level(c["gin"][1], c["g"][1], c["valid"][1], mode="ref")
    assert level.chain_accum_level_cuda.launches == n0 + 1


def test_wrapper_rejects_bad_arguments(cuda):
    x = _inputs(2, 100)
    c = {k: _both(v, cuda) for k, v in x.items()}
    with pytest.raises(TypeError):
        level.chain_accum_level_cuda(c["gin"][1].double(), c["g"][1],
                                     c["valid"][1])
    with pytest.raises(ValueError):
        level.chain_accum_level_cuda(c["gin"][1], c["g"][1][:, :50],
                                     c["valid"][1])
    with pytest.raises(ValueError):
        level.chain_accum_level_cuda(c["gin"][1], c["g"][0], c["valid"][1])


def test_views_inside_larger_tensors(cuda):
    # rows of a [K, d] batch at odd offsets (not 16-byte aligned for
    # d = 7850) and [W] slices of a [L, W] schedule, as run_chain and
    # execute hand them over
    w, d = 2, 7850
    x = _inputs(w + 3, d, seed=5)
    c = {k: _both(v, cuda) for k, v in x.items()}
    sl = lambda t: t[1:1 + w]
    pick = lambda i: [sl(c[k][i]) for k in ("g", "e", "gin", "weight",
                                            "tau", "part", "valid")]
    want = ref.ref_cl_fuse_level(*pick(0), c["gm"][0], sl(c["mask"][0]))
    got = level.cl_fuse_level_cuda(*pick(1), c["gm"][1], sl(c["mask"][1]))
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        _same(a, b)


# ---------------------------------------------------------------------------
# τ search
# ---------------------------------------------------------------------------

def _tables(op, branch):
    hi = torch.clamp(op.abs().amax(-1), min=1e-30) * sp._HI_SCALE
    return sp._hist_tables(torch.zeros_like(hi), hi, branch)


def _operand(x, i, c):
    return [c[k][i] for k in ("g", "e", "gin", "weight", "part")]


@pytest.mark.parametrize("w,d", SHAPES)
@pytest.mark.parametrize("gm", [None, "shared", "lane"])
@pytest.mark.parametrize("include_gamma", [False, True])
def test_count_ge_fused_level_kernel(cuda, w, d, gm, include_gamma):
    x = _inputs(w, d, seed=3)
    c = {k: _both(v, cuda) for k, v in x.items()}
    gmk = {None: None, "shared": "gm", "lane": "gmw"}[gm]
    mask = lambda i: c[gmk][i] if gmk else None
    op = ref.fused_operand(*_operand(x, 0, c), mask(0),
                           include_gamma=include_gamma)
    taus = _tables(op, 64)[0]
    want = ref.ref_count_ge_fused_level(*_operand(x, 0, c), taus, mask(0),
                                        include_gamma=include_gamma)
    n0 = level.count_ge_fused_level_cuda.launches
    got = level.count_ge_fused_level_cuda(*_operand(x, 1, c),
                                          taus.to(cuda), mask(1),
                                          include_gamma=include_gamma)
    torch.cuda.synchronize()
    assert level.count_ge_fused_level_cuda.launches == n0 + 1
    _same(want, got)


@pytest.mark.parametrize("w,d", SHAPES)
def test_count_ge_level_kernel_taus_in_any_order(cuda, w, d):
    x = _inputs(w, d, seed=4)
    rng = np.random.default_rng(4)
    taus = np.abs(rng.standard_normal((w, 48))).astype(np.float32)
    taus[:, 5] = taus[:, 9]
    taus[:, 7], taus[:, 8], taus[:, 11] = np.inf, -np.inf, 0.0
    xs, xg = _both(x["g"], cuda)
    ts, tg = _both(taus, cuda)
    _same(ref.ref_count_ge_level(xs, ts), level.count_ge_level_cuda(xg, tg))


@pytest.mark.parametrize("n", [1, 64, level.MAX_TAUS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_count_ge_level_kernel_on_special_lanes(cuda, n, dtype):
    """Lanes whose taus span other ranges (all ≤ 0; ties with ±inf and NaN;
    all equal; subnormals to 1e30; a first scan round), each lane's rows on
    the edges of its rank table, at d = 3·8192 + 77: several tiles per
    lane, lanes that start off a 16-byte boundary, and the [W, d] operand
    at an odd offset of a larger buffer (the wrapper copies it, without a
    cast: bfloat16 rows reach the kernel as bfloat16)."""
    taus = ref.count_level_edge_taus(n, seed=n)
    w, d = taus.shape[0], 3 * 8192 + 77
    x = ref.count_level_edge_rows(taus, d, seed=n).to(dtype)
    flat = torch.zeros(w * d + 1, dtype=dtype)
    flat[1:] = x.reshape(-1)
    got = ops.count_ge_level(flat.to(cuda)[1:].view(w, d), taus.to(cuda),
                             mode="always")
    _same(ref.ref_count_ge_level(x, taus), got)
    if n == level.MAX_TAUS:
        with pytest.raises(ValueError, match=str(n)):
            level.count_ge_level_cuda(x.to(cuda),
                                      torch.ones((w, n + 1), device=cuda))


@pytest.mark.parametrize("w,d", SHAPES)
@pytest.mark.parametrize("gm", [None, "shared", "lane"])
@pytest.mark.parametrize("include_gamma", [False, True])
@pytest.mark.parametrize("branch", [64, 256])
def test_hist_topq_level_kernel(cuda, w, d, gm, include_gamma, branch):
    # branch 256 exceeds what shared memory holds: the global-atomics variant
    x = _inputs(w, d, seed=5)
    c = {k: _both(v, cuda) for k, v in x.items()}
    gmk = {None: None, "shared": "gm", "lane": "gmw"}[gm]
    mask = lambda i: c[gmk][i] if gmk else None
    op = ref.fused_operand(*_operand(x, 0, c), mask(0),
                           include_gamma=include_gamma)
    tables = _tables(op, branch)
    want = ref.ref_hist_topq_level(*_operand(x, 0, c), tables, mask(0),
                                   include_gamma=include_gamma)
    got = level.hist_topq_level_cuda(*_operand(x, 1, c),
                                     tuple(t.to(cuda) for t in tables),
                                     mask(1), include_gamma=include_gamma)
    torch.cuda.synchronize()
    assert (branch <= level.hist_shared_max_branch()) == (branch == 64)
    for a, b in zip(want, got):
        _same(a, b)


def test_hist_topq_level_kernel_on_bin_edges(cuda):
    w, d = 2, 7850
    rng = np.random.default_rng(6)
    g = rng.standard_normal((w, d)).astype(np.float32)
    tables = _tables(torch.from_numpy(g), 64)
    edge = ref.hist_edge_magnitudes(tables, 4000, seed=2).numpy()
    g[:, :4000] = edge
    cpu = [torch.from_numpy(a) for a in (g, np.zeros_like(g))]
    lane = [torch.ones(w), torch.ones(w)]
    want = ref.ref_hist_topq_level(cpu[0], cpu[1], None, *lane, tables)
    got = level.hist_topq_level_cuda(
        *(t.to(cuda) for t in cpu), None, *(t.to(cuda) for t in lane),
        tuple(t.to(cuda) for t in tables))
    for a, b in zip(want, got):
        _same(a, b)


@pytest.mark.parametrize("branch", [64, 256])
@pytest.mark.parametrize("include_gamma", [False, True])
def test_hist_topq_level_kernel_special_magnitudes(cuda, branch,
                                                   include_gamma):
    """NaN, ±inf, ±0 and subnormal magnitudes against finite tables (lane
    0), an all-zero operand with its own zero-width tables (lane 1), and
    magnitudes on the bin edges (lane 2)."""
    w, d = 3, 7850
    g = torch.from_numpy(np.random.default_rng(branch).standard_normal(
        (w, d)).astype(np.float32))
    g[1] = 0.0
    tables = _tables(g, branch)
    g[0, :500] = ref.special_magnitudes(500, seed=branch)
    g[2, :4000] = ref.hist_edge_magnitudes(tables, 4000, seed=branch)[2]
    zeros, one = torch.zeros_like(g), torch.ones(w)
    args = (g, zeros, zeros, one, one)
    want = ref.ref_hist_topq_level(*args, tables,
                                   include_gamma=include_gamma)
    got = level.hist_topq_level_cuda(
        *(t.to(cuda) for t in args), tuple(t.to(cuda) for t in tables),
        include_gamma=include_gamma)
    for a, b in zip(want, got):
        _same(a, b)


def test_hist_topq_level_kernel_searches_where_the_estimate_cannot(cuda):
    """Tables outside the estimate's conditions (a negative width, a NaN
    bracket bottom, a +inf candidate) take the binary searches."""
    w, d = 3, 7850
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (w, d)).astype(np.float32))
    tau1, new_lo, w2, top_shift = (t.clone() for t in _tables(g, 64))
    w2[0, 3] = -w2[0, 3]
    new_lo[1, 5] = math.nan
    tau1[2, -1] = math.inf
    tables = (tau1, new_lo, w2, top_shift)
    zeros, one = torch.zeros_like(g), torch.ones(w)
    want = ref.ref_hist_topq_level(g, zeros, None, one, one, tables)
    got = level.hist_topq_level_cuda(
        *(t.to(cuda) for t in (g, zeros)), None,
        *(t.to(cuda) for t in (one, one)), tuple(t.to(cuda) for t in tables))
    for a, b in zip(want, got):
        _same(a, b)


def test_tau_search_ops_launch_on_cuda(cuda):
    x = _inputs(3, 1000, seed=7)
    c = {k: _both(v, cuda) for k, v in x.items()}
    args = _operand(x, 1, c)
    tables = _tables(ref.fused_operand(*args), 16)
    n0 = [k.launches for k in level.KERNELS]
    for mode in ("auto", "always"):
        ops.count_ge_fused_level(*args, tables[0], mode=mode)
        ops.hist_topq_level(*args, tables, mode=mode)
        ops.count_ge_level(args[0], tables[0], mode=mode)
    ops.hist_topq_level(*args, tables, mode="ref")
    grown = [a - b for a, b in zip((k.launches for k in level.KERNELS), n0)]
    assert grown == [0, 0, 0, 2, 2, 2, 0, 0, 0]


# ---------------------------------------------------------------------------
# the resident forms: one block per lane, the lane's operand in shared memory
# ---------------------------------------------------------------------------

RESIDENT_D = (281, 7850, level.RESIDENT_MAX_D)
RESIDENT_GM = [(None, 0), ("shared", 0), ("lanes", 0), ("cohort", 4)]


def _same_nan(a, b):
    """Bit for bit, a NaN equal to any NaN (the card's arithmetic makes
    its own NaN payloads)."""
    a, b = a.cpu(), b.cpu()
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == torch.float32:
        nan = torch.isnan(a)
        assert torch.equal(nan, torch.isnan(b))
        a, b = (torch.where(nan, 0, t.view(torch.int32)) for t in (a, b))
    assert torch.equal(a, b)


def _resident(w, d, form, cohorts, cuda, seed):
    x = ref.resident_edge_lanes(w, d, seed)
    x["gm"] = ref.resident_gmask(form, w, d, seed, cohorts)
    return x, {k: None if v is None else v.to(cuda) for k, v in x.items()}


@pytest.mark.parametrize("d", RESIDENT_D)
@pytest.mark.parametrize("form,cohorts", RESIDENT_GM)
@pytest.mark.parametrize("include_gamma", [False, True])
def test_tau_search_fused_level_kernel(cuda, d, form, cohorts,
                                       include_gamma):
    """τ and every round's counts = the plain search on the CPU, on the
    edge lanes (ties, NaN and ±inf, zeros, p = 0), for q ≤ 0 … q > d, one
    and three rounds, 64 candidates and the largest resident branch."""
    cpu, gpu = _resident(28, d, form, cohorts, cuda, seed=d)
    for q, rounds, branch in [(0, 3, 64), (11, 3, 64), (78, 1, 64),
                              (d, 3, 64), (d + 3, 3, 64),
                              (78, 2, level.RESIDENT_MAX_BRANCH)]:
        kw = dict(q=q, branch=branch, rounds=rounds,
                  include_gamma=include_gamma, gmask_cohorts=cohorts)
        pick = lambda t: (t["g"], t["e"], t["gin"], t["w"], t["p"],  # noqa
                          t["gm"])
        want = ref.ref_tau_search_fused_level(*pick(cpu), **kw)
        got = level.tau_search_fused_level_cuda(*pick(gpu), **kw)
        torch.cuda.synchronize()
        _same_nan(want[0], got[0])
        _same(want[1], got[1])


@pytest.mark.parametrize("d", RESIDENT_D)
@pytest.mark.parametrize("form,cohorts", RESIDENT_GM)
@pytest.mark.parametrize("with_err", [False, True])
def test_cl_fuse_select_level_kernel(cuda, d, form, cohorts, with_err):
    """γ_out, e′, nnz, nnz_off (and the pinned ‖e′‖²) = the plain
    exact CL step on the CPU, on the edge lanes, for q ≤ 0 … q > d."""
    cpu, gpu = _resident(28, d, form, cohorts, cuda, seed=d + 1)
    pick = lambda t: (t["g"], t["e"], t["gin"], t["w"], t["p"],  # noqa
                      t["valid"], t["gm"])
    for q in (0, 1, 11, 78, d - 1, d, d + 3):
        kw = dict(q=q, gmask_cohorts=cohorts, with_err=with_err)
        want = ref.ref_cl_fuse_select_level(*pick(cpu), **kw)
        got = level.cl_fuse_select_level_cuda(*pick(gpu), **kw)
        torch.cuda.synchronize()
        assert len(got) == len(want) == 4 + with_err
        for a, b in zip(want, got):
            _same_nan(a, b)


IA_FORMS = ([("sia", None, 0), ("re_sia", None, 0)]
            + [("tc_sia", f, b) for f, b in RESIDENT_GM + [("odd", 0)]])


def _ia_forms(cpu, gpu, form, cohorts, d):
    """The exact (q ≤ 0 … q > d) and τ-given forms of an
    ``ia_fuse_select_level`` call on the CPU and on the card."""
    tau = ref.resident_taus(cpu, cpu["gm"], cohorts, 11)
    out = [(dict(q=q), dict(q=q)) for q in (0, 1, 11, 78, d - 1, d, d + 3)]
    return out + [(dict(tau=tau), dict(tau=tau.to(gpu["g"].device)))]


@pytest.mark.parametrize("d", RESIDENT_D)
@pytest.mark.parametrize("kind,form,cohorts", IA_FORMS)
@pytest.mark.parametrize("with_err", [False, True])
def test_ia_fuse_select_level_kernel(cuda, d, kind, form, cohorts, with_err):
    """γ_out, e′, nnz, nnz_off (and the pinned ‖e′‖²) of the resident SIA,
    RE-SIA and TC-SIA step = its plain version on the CPU, on the edge
    lanes (γ_in = −0.0 on lane 3, a NaN τ on lane 2), for q ≤ 0 … q > d
    and a given τ, over the global-mask forms of TC-SIA."""
    cpu, gpu = _resident(28, d, form, cohorts, cuda, seed=d + 2)
    pick = lambda t: (t["g"], t["e"], t["gin"], t["w"], t["p"],  # noqa
                      t["valid"], t["gm"])
    for on_cpu, on_card in _ia_forms(cpu, gpu, form, cohorts, d):
        kw = dict(kind=kind, gmask_cohorts=cohorts, with_err=with_err)
        want = ref.ref_ia_fuse_select_level(*pick(cpu), **kw, **on_cpu)
        got = level.ia_fuse_select_level_cuda(*pick(gpu), **kw, **on_card)
        torch.cuda.synchronize()
        assert len(got) == len(want) == 4 + with_err
        for a, b in zip(want, got):
            _same_nan(a, b)


@pytest.mark.parametrize("kind", ["sia", "re_sia", "tc_sia"])
@pytest.mark.parametrize("impl", ["exact", "threshold"])
def test_ia_dispatch_on_the_card(cuda, kind, impl):
    """An SIA, RE-SIA or TC-SIA level step on the card at the largest
    resident d launches ``ia_fuse_select_level`` once (and the resident τ
    search); at d + 1 ``sparsify_ef_level`` and ``chain_accum_level``
    (and ``count_ge_fused_level`` once a round). Both equal the step on
    the CPU."""
    from repro_torch.core.algorithms import AggConfig, level_step
    cfg = AggConfig(kind=kind, q=78, topq_impl=impl, hist_branch=64,
                    err_sq_mode="kernel")
    for d in (level.RESIDENT_MAX_D, level.RESIDENT_MAX_D + 1):
        cpu, gpu = _resident(3, d, "shared", 0, cuda, seed=d)
        pick = lambda t: (t["g"], t["gin"], t["e"], t["w"], t["p"],  # noqa
                          t["gm"], None, t["valid"])
        before = {fn.__name__: fn.launches for fn in level.KERNELS}
        got = level_step(cfg)(*pick(gpu))
        torch.cuda.synchronize()
        grown = {n.replace("_cuda", ""): fn.launches - before[n]
                 for n, fn in ((f.__name__, f) for f in level.KERNELS)
                 if fn.launches - before[n]}
        search = {} if impl == "exact" else (
            {"tau_search_fused_level": 1} if d <= level.RESIDENT_MAX_D
            else {"count_ge_fused_level": 3})
        want = ({"ia_fuse_select_level": 1} if d <= level.RESIDENT_MAX_D
                else {"sparsify_ef_level": 1, "chain_accum_level": 1})
        assert grown == {**want, **search} == level_launches(cfg, d), (
            d, grown)
        want = level_step(cfg)(*pick(cpu))
        for a, b in zip(want[:2] + tuple(want[2]), got[:2] + tuple(got[2])):
            _same_nan(a, b)


@pytest.mark.parametrize("w", [1, 3])
def test_resident_kernels_on_few_lanes(cuda, w):
    """W = 1 and 3 lanes at the paper's d, a lane-shared mask."""
    d = 7850
    cpu, gpu = _resident(w, d, "shared", 0, cuda, seed=w)
    op = lambda t: (t["g"], t["e"], t["gin"], t["w"], t["p"])  # noqa
    for q in (0, 78, d):
        want = ref.ref_cl_fuse_select_level(*op(cpu), cpu["valid"],
                                            cpu["gm"], q=q, with_err=True)
        got = level.cl_fuse_select_level_cuda(*op(gpu), gpu["valid"],
                                              gpu["gm"], q=q, with_err=True)
        for a, b in zip(want, got):
            _same_nan(a, b)
        want = ref.ref_tau_search_fused_level(*op(cpu), cpu["gm"], q=q,
                                              branch=64, rounds=3,
                                              include_gamma=True)
        got = level.tau_search_fused_level_cuda(*op(gpu), gpu["gm"], q=q,
                                                branch=64, rounds=3,
                                                include_gamma=True)
        _same_nan(want[0], got[0])
        _same(want[1], got[1])
        for kind in ("sia", "re_sia", "tc_sia"):
            gm = (cpu["gm"], gpu["gm"]) if kind == "tc_sia" else (None,) * 2
            want = ref.ref_ia_fuse_select_level(*op(cpu), cpu["valid"],
                                                gm[0], kind=kind, q=q,
                                                with_err=True)
            got = level.ia_fuse_select_level_cuda(*op(gpu), gpu["valid"],
                                                  gm[1], kind=kind, q=q,
                                                  with_err=True)
            for a, b in zip(want, got):
                _same_nan(a, b)


@pytest.mark.parametrize("impl", ["exact", "threshold"])
def test_resident_dispatch_on_the_card(cuda, impl):
    """A CL-SIA level step on the card at the largest resident d launches
    the resident kernel once; at d + 1 the multi-block chain
    (``cl_fuse_level``, ``count_ge_fused_level`` once a round). Both equal
    the step on the CPU."""
    from repro_torch.core.algorithms import AggConfig, level_step
    cfg = AggConfig(kind="cl_sia", q=78, topq_impl=impl, hist_branch=64,
                    err_sq_mode="kernel")
    for d in (level.RESIDENT_MAX_D, level.RESIDENT_MAX_D + 1):
        cpu, gpu = _resident(3, d, None, 0, cuda, seed=d)
        pick = lambda t: (t["g"], t["gin"], t["e"], t["w"], t["p"],  # noqa
                          torch.zeros((d,), device=t["g"].device), None,
                          t["valid"])
        before = {fn.__name__: fn.launches for fn in level.KERNELS}
        got = level_step(cfg)(*pick(gpu))
        torch.cuda.synchronize()
        grown = {n.replace("_cuda", ""): fn.launches - before[n]
                 for n, fn in ((f.__name__, f) for f in level.KERNELS)
                 if fn.launches - before[n]}
        if d <= level.RESIDENT_MAX_D:
            want = ({"cl_fuse_select_level": 1} if impl == "exact" else
                    {"cl_fuse_level": 1, "tau_search_fused_level": 1})
        else:
            want = ({"cl_fuse_level": 1} if impl == "exact" else
                    {"cl_fuse_level": 1, "count_ge_fused_level": 3})
        assert grown == want == level_launches(cfg, d), (d, grown)
        want = level_step(cfg)(*pick(cpu))
        for a, b in zip(want[:2] + tuple(want[2]), got[:2] + tuple(got[2])):
            _same_nan(a, b)


def test_resident_kernels_on_two_cards(cuda):
    """The largest resident lanes, whose shared memory is above the 48 KB a
    block gets by default, on ``cuda:0`` and then on ``cuda:1``: each card
    raises the kernels' limit in its own context, and both cards equal the
    plain versions on the CPU."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    d = level.RESIDENT_MAX_D
    cpu, _ = _resident(3, d, "lanes", 0, cuda, seed=7)
    op = lambda t: (t["g"], t["e"], t["gin"], t["w"], t["p"])  # noqa
    for dev in ("cuda:0", "cuda:1"):
        gpu = {k: None if v is None else v.to(dev) for k, v in cpu.items()}
        for with_err in (False, True):
            want = ref.ref_cl_fuse_select_level(*op(cpu), cpu["valid"],
                                                cpu["gm"], q=78,
                                                with_err=with_err)
            got = level.cl_fuse_select_level_cuda(*op(gpu), gpu["valid"],
                                                  gpu["gm"], q=78,
                                                  with_err=with_err)
            for a, b in zip(want, got):
                assert b.device == torch.device(dev)
                _same_nan(a, b)
            want = ref.ref_ia_fuse_select_level(*op(cpu), cpu["valid"],
                                                cpu["gm"], kind="tc_sia",
                                                q=78, with_err=with_err)
            got = level.ia_fuse_select_level_cuda(*op(gpu), gpu["valid"],
                                                  gpu["gm"], kind="tc_sia",
                                                  q=78, with_err=with_err)
            for a, b in zip(want, got):
                assert b.device == torch.device(dev)
                _same_nan(a, b)
        want = ref.ref_tau_search_fused_level(*op(cpu), cpu["gm"], q=78,
                                              branch=64, rounds=3,
                                              include_gamma=True)
        got = level.tau_search_fused_level_cuda(*op(gpu), gpu["gm"], q=78,
                                                branch=64, rounds=3,
                                                include_gamma=True)
        _same_nan(want[0], got[0])
        _same(want[1], got[1])


def test_resident_ops_launch_on_cuda(cuda):
    """The ``ops`` entries launch the resident kernels under ``"auto"``
    and ``"always"``, refuse a lane past the rule, and the compiled
    limits are the wrapper's."""
    assert level.resident_limits() == (level.RESIDENT_MAX_D,
                                       level.RESIDENT_MAX_BRANCH)
    _, gpu = _resident(3, 1000, "shared", 0, cuda, seed=3)
    op = (gpu["g"], gpu["e"], gpu["gin"], gpu["w"], gpu["p"])
    n0 = [k.launches for k in level.KERNELS]
    for mode in ("auto", "always"):
        ops.cl_fuse_select_level(*op, gpu["valid"], gpu["gm"], q=10,
                                 mode=mode)
        ops.tau_search_fused_level(*op, gpu["gm"], q=10, branch=64,
                                   rounds=3, mode=mode)
        ops.ia_fuse_select_level(*op, gpu["valid"], gpu["gm"],
                                 kind="tc_sia", q=10, mode=mode)
    grown = [a - b for a, b in zip((k.launches for k in level.KERNELS), n0)]
    assert grown == [0, 0, 0, 0, 0, 0, 2, 2, 2]
    big = torch.zeros((1, level.RESIDENT_MAX_D + 1), device=cuda)
    one = torch.ones((1,), device=cuda)
    with pytest.raises(ValueError):
        level.cl_fuse_select_level_cuda(big, big, big, one, one, one, q=3)
    with pytest.raises(ValueError):
        level.tau_search_fused_level_cuda(big, big, big, one, one, q=3,
                                          branch=64, rounds=3)
    with pytest.raises(ValueError):
        level.ia_fuse_select_level_cuda(big, big, big, one, one, one,
                                        kind="sia", q=3)


# ---------------------------------------------------------------------------
# the cohort-shared [B, d] global mask
# ---------------------------------------------------------------------------

# (W, d, B): cohort rows at b·d with d % 4 = 2, 1, 3 and 0
COHORT_SHAPES = [(6, 7850, 3), (4, 2 * 8192 + 77, 2), (8, 3, 4),
                 (4, 8192, 2), (6, 7850, 6)]


def _cohort_inputs(w, d, b, cuda, seed):
    x = _inputs(w, d, seed=seed)
    x["gmc"] = (np.random.default_rng(seed + 1).random((b, d)) < 0.1
                ).astype(np.float32)
    return {k: _both(v, cuda) for k, v in x.items()}


@pytest.mark.parametrize("w,d,b", COHORT_SHAPES)
@pytest.mark.parametrize("with_err", [False, True])
def test_cl_fuse_level_kernel_cohort_gmask(cuda, w, d, b, with_err):
    c = _cohort_inputs(w, d, b, cuda, seed=11)
    pick = lambda i: [c[k][i] for k in ("g", "e", "gin", "weight", "tau",
                                        "part", "valid", "gmc", "mask")]
    want = ref.ref_cl_fuse_level(*pick(0), gmask_cohorts=b,
                                 with_err=with_err)
    n0 = level.cl_fuse_level_cuda.launches
    got = level.cl_fuse_level_cuda(*pick(1), gmask_cohorts=b,
                                   with_err=with_err)
    torch.cuda.synchronize()
    assert level.cl_fuse_level_cuda.launches == n0 + 1
    for u, v in zip(want, got):
        _same(u, v)


@pytest.mark.parametrize("w,d,b", COHORT_SHAPES)
def test_chain_accum_level_kernel_cohort_gmask(cuda, w, d, b):
    c = _cohort_inputs(w, d, b, cuda, seed=12)
    args = lambda i: (c["gin"][i], c["g"][i], c["valid"][i], c["gmc"][i])
    want = ref.ref_chain_accum_level(*args(0), gmask_cohorts=b)
    got = level.chain_accum_level_cuda(*args(1), gmask_cohorts=b)
    torch.cuda.synchronize()
    for u, v in zip(want, got):
        _same(u, v)


@pytest.mark.parametrize("b", [0, 2])
def test_gmask_view_off_a_16_byte_boundary(cuda, b):
    # a lane-shared [d] (b = 0) or cohort-shared [b, d] mask that starts 4
    # bytes into its buffer: the kernels take float4 loads from mask rows
    # with the lane row's alignment, so the wrapper copies such a view
    w, d = 4, 7850
    rows = max(b, 1)
    flat = (np.random.default_rng(14).random(rows * d + 1) < 0.1
            ).astype(np.float32)
    gm = [t[1:].view(rows, d) if b else t[1:]
          for t in _both(flat, cuda)]
    assert gm[1].data_ptr() % 16
    c = {k: _both(v, cuda) for k, v in _inputs(w, d, seed=13).items()}
    args = lambda i: (c["gin"][i], c["g"][i], c["valid"][i], gm[i])
    kw = dict(gmask_cohorts=b) if b else {}
    want = ref.ref_chain_accum_level(*args(0), **kw)
    got = level.chain_accum_level_cuda(*args(1), **kw)
    torch.cuda.synchronize()
    for u, v in zip(want, got):
        _same(u, v)


@pytest.mark.parametrize("w,d,b", COHORT_SHAPES)
@pytest.mark.parametrize("include_gamma", [False, True])
@pytest.mark.parametrize("branch", [64, 256])
def test_tau_search_kernels_cohort_gmask(cuda, w, d, b, include_gamma,
                                         branch):
    c = _cohort_inputs(w, d, b, cuda, seed=13)
    kw = dict(include_gamma=include_gamma, gmask_cohorts=b)
    op = ref.fused_operand(*_operand(None, 0, c), c["gmc"][0], **kw)
    tables = _tables(op, branch)
    want = ref.ref_count_ge_fused_level(*_operand(None, 0, c), tables[0],
                                        c["gmc"][0], **kw)
    got = level.count_ge_fused_level_cuda(*_operand(None, 1, c),
                                          tables[0].to(cuda), c["gmc"][1],
                                          **kw)
    torch.cuda.synchronize()
    _same(want, got)
    want = ref.ref_hist_topq_level(*_operand(None, 0, c), tables,
                                   c["gmc"][0], **kw)
    got = level.hist_topq_level_cuda(*_operand(None, 1, c),
                                     tuple(t.to(cuda) for t in tables),
                                     c["gmc"][1], **kw)
    torch.cuda.synchronize()
    for u, v in zip(want, got):
        _same(u, v)


def test_cohort_gmask_rejects_cohorts_that_do_not_divide_the_lanes(cuda):
    c = _cohort_inputs(6, 100, 4, cuda, seed=14)
    lanes = (c["gin"][1], c["g"][1], c["valid"][1])
    with pytest.raises(ValueError, match="incompatible"):
        level.chain_accum_level_cuda(*lanes, c["gmc"][1], gmask_cohorts=4)
    with pytest.raises(ValueError, match="incompatible"):
        level.chain_accum_level_cuda(*lanes, c["gmc"][1][:3],
                                     gmask_cohorts=2)
    tables = _tables(ref.fused_operand(*_operand(None, 1, c)), 16)
    for fn, arg in ((level.count_ge_fused_level_cuda, tables[0]),
                    (level.hist_topq_level_cuda, tables)):
        with pytest.raises(ValueError, match="incompatible"):
            fn(*_operand(None, 1, c), arg, c["gmc"][1], gmask_cohorts=4)
    n0 = level.cl_fuse_level_cuda.launches
    with pytest.raises(ValueError, match="incompatible"):
        level.cl_fuse_level_cuda(
            *(c[k][1] for k in ("g", "e", "gin", "weight", "tau", "part",
                                "valid")), c["gmc"][1], gmask_cohorts=4)
    assert level.cl_fuse_level_cuda.launches == n0


def test_ops_cohort_gmask_launch_on_cuda(cuda):
    c = _cohort_inputs(4, 1000, 2, cuda, seed=15)
    args = _operand(None, 1, c)
    tables = _tables(ref.fused_operand(*args), 16)
    n0 = [k.launches for k in level.KERNELS]
    for mode in ("auto", "always"):
        ops.chain_accum_level(c["gin"][1], c["g"][1], c["valid"][1],
                              c["gmc"][1], gmask_cohorts=2, mode=mode)
        ops.cl_fuse_level(*(c[k][1] for k in ("g", "e", "gin", "weight",
                                              "tau", "part", "valid")),
                          c["gmc"][1], gmask_cohorts=2, mode=mode)
        ops.count_ge_fused_level(*args, tables[0], c["gmc"][1],
                                 gmask_cohorts=2, mode=mode)
        ops.hist_topq_level(*args, tables, c["gmc"][1], gmask_cohorts=2,
                            mode=mode)
    grown = [a - b for a, b in zip((k.launches for k in level.KERNELS), n0)]
    assert grown == [2, 0, 2, 2, 2, 0, 0, 0, 0]


# ---------------------------------------------------------------------------
# scalar [d] kernels
# ---------------------------------------------------------------------------

ROW_SHAPES = [7850, 3, 8192, 2 * 8192 + 77, 65539]
ROW_DTYPES = [torch.float32, torch.bfloat16]


def _rows(d, dtype, dev, seed=0, offset=0):
    """→ (CPU rows, card rows): g, e, gamma_in in ``dtype``, a float32
    mask; with ``offset``, views that start that many elements into a
    larger tensor (not on a 16-byte boundary for an odd offset)."""
    rng = np.random.default_rng(seed)
    n = d + offset
    f = lambda s: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(n) * s).astype(np.float32))
    full = dict(g=f(1.0).to(dtype), e=f(0.3).to(dtype),
                gin=(f(1.0) * (torch.from_numpy(rng.random(n)) < 0.3)).to(
                    dtype),
                mask=torch.from_numpy((rng.random(n) < 0.05).astype(
                    np.float32)))
    cpu = {k: v[offset:] for k, v in full.items()}
    gpu = {k: v.to(dev)[offset:] for k, v in full.items()}
    return cpu, gpu


def _same_t(a, b):
    a, b = a.cpu(), b.cpu()
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.dtype in view:
        a, b = a.contiguous().view(view[a.dtype]), b.contiguous().view(
            view[a.dtype])
    assert torch.equal(a, b)


def _scalars(form, dev, *values):
    """The scalar arguments as Python numbers or one-element tensors on
    the card (read by pointer in the kernel)."""
    if form == "number":
        return values
    return tuple(torch.tensor([v], dtype=torch.float32, device=dev)
                 for v in values)


def _row_taus(seed, n=48):
    """Shuffled candidates with τ = −1, 0, +inf and a tie."""
    rng = np.random.default_rng(seed)
    taus = np.abs(rng.standard_normal(n)).astype(np.float32) * 1.5
    taus[:4] = [-1.0, 0.0, np.inf, taus[7]]
    return torch.from_numpy(rng.permutation(taus))


@pytest.mark.parametrize("d", ROW_SHAPES)
@pytest.mark.parametrize("dtype", ROW_DTYPES)
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("form", ["number", "tensor"])
def test_sparsify_ef_kernel(cuda, d, dtype, with_mask, form):
    cpu, gpu = _rows(d, dtype, cuda, seed=11)
    mask = lambda c: c["mask"] if with_mask else None  # noqa: E731
    want = ref.ref_sparsify_ef(cpu["g"], cpu["e"], mask(cpu), 1.7, 1.2)
    n0 = sparsify_ef.sparsify_ef_cuda.launches
    got = sparsify_ef.sparsify_ef_cuda(gpu["g"], gpu["e"], mask(gpu),
                                       *_scalars(form, cuda, 1.7, 1.2))
    torch.cuda.synchronize()
    assert sparsify_ef.sparsify_ef_cuda.launches == n0 + 1
    for a, b in zip(want, got):
        _same_t(a, b)


@pytest.mark.parametrize("d", ROW_SHAPES)
@pytest.mark.parametrize("dtype", ROW_DTYPES)
@pytest.mark.parametrize("form", ["number", "tensor"])
def test_cl_fuse_kernel(cuda, d, dtype, form):
    cpu, gpu = _rows(d, dtype, cuda, seed=12)
    want = ref.ref_cl_fuse(cpu["g"], cpu["e"], cpu["gin"], 0.8, 1.4)
    got = chain_accum.cl_fuse_cuda(gpu["g"], gpu["e"], gpu["gin"],
                                   *_scalars(form, cuda, 0.8, 1.4))
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        _same_t(a, b)


@pytest.mark.parametrize("d", ROW_SHAPES)
@pytest.mark.parametrize("dtype", ROW_DTYPES)
def test_chain_accum_kernel(cuda, d, dtype):
    cpu, gpu = _rows(d, dtype, cuda, seed=13)
    want = ref.ref_chain_accum(cpu["gin"], cpu["g"])
    got = chain_accum.chain_accum_cuda(gpu["gin"], gpu["g"])
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        _same_t(a, b)


@pytest.mark.parametrize("d", ROW_SHAPES)
@pytest.mark.parametrize("dtype", ROW_DTYPES)
def test_count_ge_kernel_taus_in_any_order(cuda, d, dtype):
    cpu, gpu = _rows(d, dtype, cuda, seed=14)
    taus = _row_taus(d)
    got = topq_threshold.count_ge_cuda(gpu["g"], taus.to(cuda))
    _same_t(ref.ref_count_ge(cpu["g"], taus), got)
    assert int(got[taus == 0.0][0]) == d and int(got[taus == np.inf][0]) == 0


@pytest.mark.parametrize("d", ROW_SHAPES)
@pytest.mark.parametrize("dtype", ROW_DTYPES)
@pytest.mark.parametrize("include_gamma", [False, True])
@pytest.mark.parametrize("form", ["number", "tensor"])
def test_count_ge_fused_kernel(cuda, d, dtype, include_gamma, form):
    cpu, gpu = _rows(d, dtype, cuda, seed=15)
    taus = _row_taus(d + 1)
    want = ref.ref_count_ge_fused(cpu["g"], cpu["e"], cpu["gin"], 0.7, 0.6,
                                  taus, include_gamma=include_gamma)
    got = topq_threshold.count_ge_fused_cuda(
        gpu["g"], gpu["e"], gpu["gin"], *_scalars(form, cuda, 0.7, 0.6),
        taus.to(cuda), include_gamma=include_gamma)
    _same_t(want, got)


@pytest.mark.parametrize("dtype", ROW_DTYPES)
@pytest.mark.parametrize("offset", [1, 3])
def test_scalar_kernels_on_unaligned_views(cuda, dtype, offset):
    d = 7850
    cpu, gpu = _rows(d, dtype, cuda, seed=16, offset=offset)
    assert gpu["g"].data_ptr() % 16 != 0
    taus = _row_taus(17)
    tau_card = torch.tensor([1.1], device=cuda)
    cases = [
        (ref.ref_sparsify_ef(cpu["g"], cpu["e"], cpu["mask"], 1.3, 1.1),
         sparsify_ef.sparsify_ef_cuda(gpu["g"], gpu["e"], gpu["mask"], 1.3,
                                      tau_card)),
        (ref.ref_cl_fuse(cpu["g"], cpu["e"], cpu["gin"], 1.3, 1.1),
         chain_accum.cl_fuse_cuda(gpu["g"], gpu["e"], gpu["gin"], 1.3,
                                  tau_card)),
        (ref.ref_chain_accum(cpu["gin"], cpu["g"]),
         chain_accum.chain_accum_cuda(gpu["gin"], gpu["g"])),
        ((ref.ref_count_ge(cpu["g"], taus),),
         (topq_threshold.count_ge_cuda(gpu["g"], taus.to(cuda)),)),
        ((ref.ref_count_ge_fused(cpu["g"], cpu["e"], cpu["gin"], 1.3, 0.5,
                                 taus, include_gamma=True),),
         (topq_threshold.count_ge_fused_cuda(
             gpu["g"], gpu["e"], gpu["gin"], 1.3, 0.5, taus.to(cuda),
             include_gamma=True),))]
    torch.cuda.synchronize()
    for want, got in cases:
        for a, b in zip(want, got):
            _same_t(a, b)


def test_count_ge_takes_up_to_max_taus(cuda):
    cpu, gpu = _rows(20011, torch.float32, cuda, seed=18)
    n = topq_threshold.MAX_TAUS
    taus = torch.from_numpy(np.random.default_rng(3).standard_normal(
        n).astype(np.float32)).abs()
    _same_t(ref.ref_count_ge(cpu["g"], taus),
            topq_threshold.count_ge_cuda(gpu["g"], taus.to(cuda)))
    with pytest.raises(ValueError, match=str(n)):
        topq_threshold.count_ge_cuda(gpu["g"], torch.ones(n + 1,
                                                          device=cuda))
    with pytest.raises(ValueError, match=str(n)):
        topq_threshold.count_ge_fused_cuda(gpu["g"], gpu["e"], None, 1.0,
                                           1.0, torch.ones(n + 1,
                                                           device=cuda))


@pytest.mark.parametrize("dtype", ROW_DTYPES)
@pytest.mark.parametrize("n", [1, 64, 4095])
def test_count_ge_kernel_on_rank_table_edges(cuda, dtype, n):
    """Elements on the bucket edges of the rank table and on the taus (one
    ulp either side) and special magnitudes; taus with −1, 0, +inf, NaN,
    ties and taus on bucket boundaries, in any order."""
    taus = ref.count_edge_taus(n, seed=n)
    x = ref.count_edge_magnitudes(taus, 20011, seed=n)
    x[:300] = ref.special_magnitudes(300, seed=n)
    x = x.to(dtype)
    got = topq_threshold.count_ge_cuda(x.to(cuda), taus.to(cuda))
    _same_t(ref.ref_count_ge(x, taus), got)


def test_scalar_ops_launch_on_cuda(cuda):
    cpu, gpu = _rows(1000, torch.float32, cuda, seed=19)
    taus = _row_taus(3).to(cuda)
    calls = {
        "count_ge": lambda m: ops.count_ge(gpu["g"], taus, mode=m),
        "sparsify_ef": lambda m: ops.sparsify_ef(gpu["g"], gpu["e"], None,
                                                 1.0, 1.0, mode=m),
        "chain_accum": lambda m: ops.chain_accum(gpu["gin"], gpu["g"],
                                                 mode=m),
        "cl_fuse": lambda m: ops.cl_fuse(gpu["g"], gpu["e"], gpu["gin"],
                                         1.0, 1.0, mode=m),
        "count_ge_fused": lambda m: ops.count_ge_fused(
            gpu["g"], gpu["e"], gpu["gin"], 1.0, 1.0, taus,
            include_gamma=True, mode=m)}
    for name, call in calls.items():
        fn = getattr(ops, name + "_cuda")
        n0 = fn.launches
        got = call("always")
        call("auto")
        want = call("ref")
        call("never")
        assert fn.launches == n0 + 2, name
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(want, got):
            _same_t(a, b)


def test_scalar_kernels_equal_the_w1_level_kernels(cuda):
    """sparsify_ef and chain_accum compute the W = 1 level kernels'
    functions (with valid = 1)."""
    _, gpu = _rows(2 * 8192 + 77, torch.float32, cuda, seed=20)
    one = lambda v: torch.tensor([v], device=cuda)  # noqa: E731
    for mask in (None, gpu["mask"]):
        a = sparsify_ef.sparsify_ef_cuda(gpu["g"], gpu["e"], mask, 1.3, 0.9)
        b = level.sparsify_ef_level_cuda(
            gpu["g"][None], gpu["e"][None],
            None if mask is None else mask[None], one(1.3), one(0.9),
            one(1.0))
        for u, v in zip(a, b):
            _same_t(u, v[0])
    a = chain_accum.chain_accum_cuda(gpu["gin"], gpu["g"])
    b = level.chain_accum_level_cuda(gpu["gin"][None], gpu["g"][None],
                                     one(1.0))
    _same_t(a[0], b[0][0])
    _same_t(a[1], b[1][0])


@pytest.mark.parametrize("q", [10, 500, 5000])
def test_threshold_search_1d_counts_on_the_card(cuda, q):
    x = torch.from_numpy(np.random.default_rng(q).standard_normal(
        50_000).astype(np.float32))
    want = sp.threshold_for_topq(x, q, count_fn=ops.count_ge)
    n0 = topq_threshold.count_ge_cuda.launches
    got = sp.threshold_for_topq(x.to(cuda), q, count_fn=ops.count_ge)
    assert topq_threshold.count_ge_cuda.launches == n0 + 3
    _same_t(want, got)


# ---------------------------------------------------------------------------
# nested plans: the level kernels at the upper stages' shapes
# ---------------------------------------------------------------------------

# an upper stage of a nested plan runs W = 1–4 lanes (the cluster heads),
# its rows the previous stage's sink rows gathered from the inbox buffer
STAGE_SHAPES = [(w, d) for d in (7850, 2 ** 23 + 125) for w in (1, 2, 4)]


@pytest.mark.parametrize("w,d", STAGE_SHAPES)
def test_level_kernels_at_upper_stage_shapes(cuda, w, d):
    """Rows 1–5 of the kernel table on W = 1, 2, 4 lanes, ``g`` a view of
    sink rows k..k+W−1 inside a larger inbox (off a 16-byte boundary
    where k·d is not a multiple of 4), bit for bit against the plain
    versions on the CPU; the level kernels take float32 rows only and
    refuse bfloat16."""
    x = _inputs(w, d, seed=20 + w)
    c = {k: _both(v, cuda) for k, v in x.items()}
    k = 5
    inbox = np.zeros((k + w + 1, d), np.float32)
    inbox[k:k + w] = x["g"]
    ib = _both(inbox, cuda)
    c["g"] = (ib[0][k:k + w], ib[1][k:k + w])
    pick = lambda i, keys: [c[n][i] for n in keys]  # noqa: E731
    fuse = ("g", "e", "gin", "weight", "tau", "part", "valid")
    calls = {
        "cl_fuse_level": (
            lambda fn, i: fn(*pick(i, fuse), c["gm"][i], c["mask"][i],
                             with_err=True),
            ref.ref_cl_fuse_level, level.cl_fuse_level_cuda),
        "sparsify_ef_level": (
            lambda fn, i: fn(c["g"][i], c["e"][i], c["mask"][i],
                             c["weight"][i], c["tau"][i], c["valid"][i],
                             with_err=True),
            ref.ref_sparsify_ef_level, level.sparsify_ef_level_cuda),
        "chain_accum_level": (
            lambda fn, i: fn(c["gin"][i], c["g"][i], c["valid"][i],
                             c["gm"][i]),
            ref.ref_chain_accum_level, level.chain_accum_level_cuda),
    }
    for name, (call, plain, kernel) in calls.items():
        n0 = kernel.launches
        got = call(kernel, 1)
        torch.cuda.synchronize()
        assert kernel.launches == n0 + 1, name
        for a, b in zip(call(plain, 0), got):
            _same(a, b)
    op = ref.fused_operand(*_operand(x, 0, c), c["gm"][0],
                           include_gamma=True)
    tables = _tables(op, 64)
    _same(ref.ref_count_ge_fused_level(*_operand(x, 0, c), tables[0],
                                       c["gm"][0], include_gamma=True),
          level.count_ge_fused_level_cuda(*_operand(x, 1, c),
                                          tables[0].to(cuda), c["gm"][1],
                                          include_gamma=True))
    want = ref.ref_hist_topq_level(*_operand(x, 0, c), tables, c["gm"][0],
                                   include_gamma=True)
    got = level.hist_topq_level_cuda(*_operand(x, 1, c),
                                     tuple(t.to(cuda) for t in tables),
                                     c["gm"][1], include_gamma=True)
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        _same(a, b)
    bf = c["g"][1].to(torch.bfloat16)
    with pytest.raises(TypeError):
        level.chain_accum_level_cuda(bf, bf, c["valid"][1])


@pytest.mark.parametrize("impl", ["exact", "scan", "hist"])
@pytest.mark.parametrize("kind", ["sia", "re_sia", "cl_sia", "tc_sia",
                                  "cl_tc_sia"])
def test_nested_round_on_the_card_equals_the_cpu(cuda, kind, impl):
    """One round of ``pod_ring_nested(4, 7)`` (K = 28, d = 7850; stage 1 a
    chain of 4 pod heads, W = 1) on the card and on the CPU, same inputs:
    aggregate, client EF, the stage EF tier and both stages' counts and
    bits bit for bit."""
    from repro_torch.agg import execute_nested, pod_ring_nested
    from repro_torch.core.algorithms import AggConfig
    kw = {"exact": {}, "scan": dict(topq_impl="threshold", tau_impl="scan",
                                    hist_rounds=3),
          "hist": dict(topq_impl="threshold", tau_impl="hist",
                       hist_rounds=2)}[impl]
    cfg = AggConfig(kind=kind, q=78, **kw)
    nested = pod_ring_nested(4, 7)
    k, d = 28, 7850
    rng = np.random.default_rng(7)
    t = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, dtype=np.float32) * np.float32(scale))
    g, e, stage_e = t(k, d, scale=0.01), t(k, d, scale=1e-3), t(4, d,
                                                              scale=1e-3)
    part = torch.ones((k,))
    part[3] = 0.0
    gm = None
    if kind in ("tc_sia", "cl_tc_sia"):
        gm = (torch.from_numpy(rng.random(d)) < 0.01).to(torch.float32)
    args = lambda dev: dict(  # noqa: E731
        grads=g.to(dev), e=e.to(dev), weights=torch.ones((k,), device=dev),
        stage_e=(stage_e.to(dev),), participate=part.to(dev),
        global_mask=None if gm is None else gm.to(dev))
    want = execute_nested(cfg, nested, **args("cpu"))
    before = [fn.launches for fn in level.KERNELS]
    got = execute_nested(cfg, nested, **args(cuda))
    torch.cuda.synchronize()
    assert sum(fn.launches for fn in level.KERNELS) > sum(before)
    for a, b in [(want.aggregate, got.aggregate), (want.e_new, got.e_new),
                 (want.stage_e_new[0], got.stage_e_new[0])]:
        _same(a, b)
    for ws, gs in zip((want.stats,) + want.stage_stats,
                      (got.stats,) + got.stage_stats):
        for f in ("nnz_out", "nnz_global", "nnz_local", "bits"):
            _same(getattr(ws, f), getattr(gs, f))


@pytest.mark.parametrize("topo", ["chain", "star", "tree"])
@pytest.mark.parametrize("kind", ["sia", "re_sia", "cl_sia", "tc_sia",
                                  "cl_tc_sia", "dense_ia"])
def test_execute_sharded_on_the_card_equals_host_execute(cuda, kind, topo):
    """The client-per-rank backend on a mesh of 28 ranks on one card
    (K = 28, d = 7850): one W = 1 level step per real slot, equal to host
    ``execute`` on the card and to the CPU mesh bit for bit — aggregate, EF
    rows, counts, bits and the pinned ``err_sq``."""
    from repro_torch.agg import compile_plan, execute
    from repro_torch.agg.device import client_mesh, execute_sharded
    from repro_torch.core.algorithms import AggConfig
    from repro_torch.topo import star_tree
    from repro_torch.topo.tree import PS, AggTree
    k, d = 28, 7850
    parent = tuple(PS if i < 3 else (i - 3) // 4 for i in range(k))
    plan = compile_plan({"chain": k, "star": star_tree(k),
                         "tree": AggTree(parent=parent)}[topo])
    cfg = AggConfig(kind=kind, q=78,
                    err_sq_mode="jnp" if kind == "dense_ia" else "kernel")
    rng = np.random.default_rng(11)
    g = torch.from_numpy(rng.standard_normal((k, d), dtype=np.float32))
    e = torch.from_numpy(rng.standard_normal((k, d), dtype=np.float32))
    part = torch.ones((k,))
    part[5] = 0.0
    gm = torch.zeros((d,))
    gm[rng.choice(d, cfg.q_global or 1, replace=False)] = 1.0
    args = lambda dev: (g.to(dev), 0.1 * e.to(dev),  # noqa: E731
                        torch.ones((k,), device=dev))
    opt = lambda dev: dict(global_mask=gm.to(dev),  # noqa: E731
                           participate=part.to(dev))
    host = execute(cfg, plan, *args(cuda), **opt(cuda))
    before = [fn.launches for fn in level.KERNELS]
    got = execute_sharded(cfg, plan, *args(cuda), **opt(cuda),
                          mesh=client_mesh(k, devices=[cuda] * k))
    torch.cuda.synchronize()
    if kind != "dense_ia":
        assert sum(fn.launches for fn in level.KERNELS) > sum(before)
    cpu = execute_sharded(cfg, plan, *args("cpu"), **opt("cpu"),
                          mesh=client_mesh(k, devices=["cpu"] * k))
    assert got.e_new.device.type == "cuda"
    for want in (host, cpu):
        _same(want.aggregate, got.aggregate)
        _same(want.e_new, got.e_new)
        for f in ("nnz_out", "nnz_global", "nnz_local", "bits"):
            _same(getattr(want.stats, f), getattr(got.stats, f))
        if cfg.err_sq_mode == "kernel":
            _same(want.stats.err_sq, got.stats.err_sq)


def _mixed_meshes(cuda, k):
    """(mesh, caller device) pairs whose transfers cross between the card
    and the CPU: the card mesh under a CPU caller, and ranks alternating
    CPU / card under a CPU and under a card caller."""
    from repro_torch.agg.device import client_mesh
    mixed = client_mesh(k, devices=["cpu", cuda] * (k // 2))
    return {"card mesh, cpu caller": (client_mesh(k, devices=[cuda] * k),
                                      "cpu"),
            "mixed mesh, cpu caller": (mixed, "cpu"),
            "mixed mesh, card caller": (mixed, cuda)}


def _same_round(want, got, exact_err):
    _same_t(want.aggregate, got.aggregate)
    _same_t(want.e_new, got.e_new)
    for f in ("nnz_out", "nnz_global", "nnz_local", "bits"):
        _same_t(getattr(want.stats, f), getattr(got.stats, f))
    if exact_err:
        _same_t(want.stats.err_sq, got.stats.err_sq)
    else:
        torch.testing.assert_close(got.stats.err_sq.cpu(),
                                   want.stats.err_sq, rtol=1e-6, atol=0)


@pytest.mark.parametrize("setup", ["card mesh, cpu caller",
                                   "mixed mesh, cpu caller",
                                   "mixed mesh, card caller"])
@pytest.mark.parametrize("topo", ["chain", "tree"])
@pytest.mark.parametrize("kind", ["sia", "re_sia", "cl_sia", "tc_sia",
                                  "cl_tc_sia", "dense_ia"])
def test_execute_sharded_across_the_card_and_the_cpu_equals_host_execute(
        cuda, kind, topo, setup):
    """Meshes whose payloads, rows and stats cross between the card and the
    CPU (K = 28, d = 7850): ``execute_sharded`` and
    ``execute_sharded_batched`` (B = 3) bit for bit host ``execute`` and
    ``execute_batched`` on the CPU — every copy from the card to the CPU
    has landed before the CPU reads it. The chain takes the compact wire on
    the CL kinds, the tree the dense one."""
    from repro_torch.agg import compile_plan, execute, execute_batched
    from repro_torch.agg.device import execute_sharded, execute_sharded_batched
    from repro_torch.core.algorithms import AggConfig
    from repro_torch.topo.tree import PS, AggTree
    k, d, b = 28, 7850, 3
    parent = tuple(PS if i < 3 else (i - 3) // 4 for i in range(k))
    plan = compile_plan({"chain": k, "tree": AggTree(parent=parent)}[topo])
    cfg = AggConfig(kind=kind, q=78,
                    err_sq_mode="jnp" if kind == "dense_ia" else "kernel")
    rng = np.random.default_rng(13)
    g = torch.from_numpy(rng.standard_normal((b, k, d), dtype=np.float32))
    e = torch.from_numpy(rng.standard_normal((b, k, d), dtype=np.float32))
    e = 0.1 * e
    w = torch.from_numpy(rng.uniform(0.5, 2.0, (b, k)).astype(np.float32))
    part = torch.ones((b, k))
    part[:, 5] = 0.0
    gm = torch.zeros((b, d))
    for c in range(b):
        gm[c, rng.choice(d, cfg.q_global or 1, replace=False)] = 1.0
    mesh, dev = _mixed_meshes(cuda, k)[setup]
    on = lambda x: x.to(dev)  # noqa: E731
    exact = cfg.err_sq_mode == "kernel"
    want = execute(cfg, plan, g[0], e[0], w[0], global_mask=gm[0],
                   participate=part[0])
    got = execute_sharded(cfg, plan, on(g[0]), on(e[0]), on(w[0]),
                          global_mask=on(gm[0]), participate=on(part[0]),
                          mesh=mesh)
    assert got.e_new.device.type == torch.device(dev).type
    _same_round(want, got, exact)
    want = execute_batched(cfg, plan, g, e, w, global_mask=gm,
                           participate=part)
    got = execute_sharded_batched(cfg, plan, on(g), on(e), on(w),
                                  global_mask=on(gm), participate=on(part),
                                  mesh=mesh)
    _same_round(want, got, exact)


@pytest.mark.parametrize("kind", ["cl_sia", "tc_sia"])
def test_device_backend_with_a_card_mesh_and_a_cpu_simulator(cuda, kind):
    """``Simulator(device="cpu", backend="device", mesh=<card mesh>)``: the
    rounds run on the card, the model on the CPU, and 3 rounds equal the
    CPU host backend's bit for bit (model, EF, bits, loss)."""
    import dataclasses

    from repro_torch.agg.device import client_mesh
    from repro_torch.configs import PAPER
    from repro_torch.core.algorithms import AggConfig
    from repro_torch.data import make_synthetic_mnist, partition_iid
    from repro_torch.fed import Simulator
    k = 8
    pc = dataclasses.replace(PAPER, num_clients=k)
    fed = partition_iid(make_synthetic_mnist(0, k * 60, device="cpu"), k,
                        torch.Generator().manual_seed(2))
    cfg = AggConfig(kind=kind, q=78)
    host = Simulator(pc, cfg, fed, device="cpu").run(3, seed=3)
    dev = Simulator(pc, cfg, fed, device="cpu", backend="device",
                    mesh=client_mesh(k, devices=[cuda] * k)).run(3, seed=3)
    assert dev["loss"] == host["loss"] and dev["bits"] == host["bits"]
    for x, y in zip(host["state"], dev["state"]):
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            if isinstance(u, torch.Tensor):
                _same_t(u, v)


# ---------------------------------------------------------------------------
# the rotated-segment lowering on the card
# ---------------------------------------------------------------------------

def _segment_plans(k):
    from repro_torch.agg import compile_plan
    from repro_torch.agg.device import ring_chain_plan
    from repro_torch.topo import star_tree
    from repro_torch.topo.tree import PS, AggTree
    parent = tuple(PS if i < 3 else (i - 3) // 4 for i in range(k))
    perm = np.random.default_rng(5).permutation(k)
    return {"ring": ring_chain_plan(k), "perm": compile_plan(perm),
            "star": compile_plan(star_tree(k)),
            "tree": compile_plan(AggTree(parent=parent))}


def _segment_inputs(k, n, seed=17):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32))
    e = 0.1 * torch.from_numpy(rng.standard_normal((k, n),
                                                   dtype=np.float32))
    gm = torch.zeros((n,))
    gm[rng.choice(n, 40, replace=False)] = 1.0
    part = torch.ones((k,))
    part[3] = 0.0
    return g, e, gm, part


def _segments_round(cfg, plan, mesh, g, e, gm, part, dev, **kw):
    from repro_torch.agg.device import run_plan_segments_local
    k = g.shape[0]
    return run_plan_segments_local(
        cfg, plan, mesh, list(g.to(dev)), list(e.to(dev)), 1.3,
        global_mask=[gm.to(dev)] * k, participate=list(part.to(dev)), **kw)


@pytest.mark.parametrize("topo", ["ring", "perm", "star", "tree"])
@pytest.mark.parametrize("kind", ["sia", "re_sia", "cl_sia", "tc_sia",
                                  "cl_tc_sia", "dense_ia"])
def test_segments_on_the_card_equal_host_execute_and_the_cpu_mesh(
        cuda, kind, topo):
    """``run_plan_segments_local`` on 28 ranks of one card (n = 7868, seg =
    281, the paper's budget per segment): each segment equals host
    ``execute`` on the card under the rotation relabelling, the ranks equal
    the CPU mesh's bit for bit (``err_sq`` under the pinned order; under
    ``"jnp"`` to rtol 1e-6), the butterfly equals the static transport, and
    each level is one level step of the card's ranks × W lanes."""
    from repro_torch.agg.device import client_mesh
    from repro_torch.core.algorithms import AggConfig
    from repro_torch.core.ring import segment_budget
    k, n = 28, 7868
    plan = _segment_plans(k)[topo]
    cfg = AggConfig(kind=kind, q=segment_budget(78 * k, k),
                    err_sq_mode="jnp" if kind == "dense_ia" else "kernel")
    g, e, gm, part = _segment_inputs(k, n)
    mesh = client_mesh(k, devices=[cuda] * k)
    before = {fn.__name__: fn.launches for fn in level.KERNELS}
    got = _segments_round(cfg, plan, mesh, g, e, gm, part, cuda)
    torch.cuda.synchronize()
    grown = {n_: fn.launches - before[fn.__name__]
             for n_, fn in ((f.__name__, f) for f in level.KERNELS)
             if fn.launches - before[fn.__name__]}
    assert grown == {name + "_cuda": c for name, c in level_launches(
        cfg, n // k, plan.shape[0]).items()}
    cpu = _segments_round(cfg, plan, client_mesh(k, devices=["cpu"] * k),
                          g, e, gm, part, "cpu")
    bf = _segments_round(cfg, plan, mesh, g, e, gm, part, cuda,
                         transport="butterfly")
    for other in (cpu, bf):
        for a, b in zip(got[0] + got[1], other[0] + other[1]):
            _same_t(b, a)
        for a, b in zip(got[2], other[2]):
            _same_t(b.bits, a.bits)
            _same_t(b.nnz, a.nnz)
            if cfg.err_sq_mode == "kernel" or other is bf:
                _same_t(b.err_sq, a.err_sq)
            else:        # a torch row sum, ordered by the device
                torch.testing.assert_close(a.err_sq.cpu(), b.err_sq,
                                           rtol=1e-6, atol=0)
    _segments_equal_host_execute(cfg, plan, got, g, e, gm, part, cuda)


@pytest.mark.parametrize("impl", ["scan", "hist"])
@pytest.mark.parametrize("kind", ["tc_sia", "cl_sia"])
def test_segments_threshold_on_the_card_equal_host_execute_and_the_cpu_mesh(
        cuda, kind, impl):
    """Threshold Top-Q through the lowering on 28 ranks of one card (n =
    7868, the odd segment width 281) on the tree: the τ search runs once
    per level on all ranks' lanes (``hist_topq_level`` once per level,
    ``count_ge_fused_level`` once per scan round), the ranks equal the CPU
    mesh's bit for bit, ``err_sq`` included, and each segment equals host
    ``execute`` on the card under the rotation relabelling."""
    from repro_torch.agg.device import client_mesh
    from repro_torch.core.algorithms import AggConfig
    from repro_torch.core.ring import segment_budget
    k, n = 28, 7868
    plan = _segment_plans(k)["tree"]
    rounds = 3 if impl == "scan" else 2
    cfg = AggConfig(kind=kind, q=segment_budget(78 * k, k),
                    err_sq_mode="kernel", topq_impl="threshold",
                    tau_impl=impl, hist_rounds=rounds, hist_branch=64)
    g, e, gm, part = _segment_inputs(k, n, 29)
    before = {fn.__name__: fn.launches for fn in level.KERNELS}
    got = _segments_round(cfg, plan, client_mesh(k, devices=[cuda] * k),
                          g, e, gm, part, cuda)
    torch.cuda.synchronize()
    grown = {n_: fn.launches - before[fn.__name__]
             for n_, fn in ((f.__name__, f) for f in level.KERNELS)
             if fn.launches - before[fn.__name__]}
    assert grown == {name + "_cuda": c for name, c in level_launches(
        cfg, n // k, plan.shape[0]).items()}
    cpu = _segments_round(cfg, plan, client_mesh(k, devices=["cpu"] * k),
                          g, e, gm, part, "cpu")
    for a, b in zip(got[0] + got[1], cpu[0] + cpu[1]):
        _same_t(b, a)
    for a, b in zip(got[2], cpu[2]):
        for f in ("bits", "nnz", "err_sq"):
            _same_t(getattr(b, f), getattr(a, f))
    _segments_equal_host_execute(cfg, plan, got, g, e, gm, part, cuda)


def _segments_equal_host_execute(cfg, plan, got, g, e, gm, part, cuda):
    """Segment s of a lowering round ``got`` equals host ``execute`` on the
    card with position p played by rank (p + s) mod K."""
    import dataclasses

    from repro_torch.agg import execute
    k, n = g.shape
    seg = n // k
    base = dataclasses.replace(plan, alive=np.ones(k, np.float32))
    for s in range(k):
        rot = [(x + s) % k for x in range(k)]
        cols = slice(s * seg, (s + 1) * seg)
        res = execute(cfg, base, g[rot, cols].to(cuda),
                      e[rot, cols].to(cuda),
                      torch.full((k,), 1.3, device=cuda),
                      global_mask=gm[cols].to(cuda),
                      participate=part[rot].to(cuda))
        _same_t(res.aggregate, got[0][s])
        for x in range(k):
            _same_t(res.e_new[x], got[1][rot[x]][cols])


def test_segments_across_the_card_and_the_cpu_equal_the_cpu_mesh(cuda):
    """Ranks alternating CPU / card (every transfer crosses) on a tree, a
    chain and the butterfly, ``run_plan_segments_batched`` with B = 2: bit
    for bit the CPU mesh's round."""
    from repro_torch.agg.device import client_mesh, run_plan_segments_batched
    from repro_torch.core.algorithms import AggConfig
    k, n, b = 28, 7868, 2
    g, e, gm, part = _segment_inputs(k, n, 19)
    cfg = AggConfig(kind="cl_tc_sia", q=78, err_sq_mode="kernel")
    mixed = client_mesh(k, devices=["cpu", cuda] * (k // 2))
    cpu = client_mesh(k, devices=["cpu"] * k)
    for name in ("ring", "tree"):
        plan = _segment_plans(k)[name]
        for tr in ("static", "butterfly"):
            want = _segments_round(cfg, plan, cpu, g, e, gm, part, "cpu",
                                   transport=tr)
            got = _segments_round(cfg, plan, mixed, g, e, gm, part, "cpu",
                                  transport=tr)
            for a, c in zip(want[0] + want[1], got[0] + got[1]):
                _same_t(a, c)
        two = lambda x: torch.stack([x, x.flip(0)], 1)  # noqa: E731
        rows = lambda x, m: [r.to(d) for r, d in  # noqa: E731
                             zip(two(x).unbind(0), m.devices)]
        outs = [run_plan_segments_batched(
            cfg, plan, m, rows(g, m), rows(e, m), 1.3,
            global_mask=[torch.stack([gm, gm]).to(d) for d in m.devices])
            for m in (cpu, mixed)]
        for a, c in zip(outs[0][0] + outs[0][1], outs[1][0] + outs[1][1]):
            _same_t(a, c)


def test_nested_segments_on_the_card_equal_the_cpu(cuda):
    """``hierarchical_ring_local`` (sizes (7, 4)) and
    ``run_nested_segments_local`` on per-pod different trees (the
    butterfly) on 28 ranks of one card: bit for bit the CPU mesh's."""
    from repro_torch.agg import compile_nested
    from repro_torch.agg.device import client_mesh, run_nested_segments_local
    from repro_torch.core.algorithms import AggConfig
    from repro_torch.core.hierarchical import hierarchical_ring_local
    from repro_torch.topo.tree import PS, AggTree
    k, n = 28, 7868
    g, e, gm, part = _segment_inputs(k, n, 23)
    pe = 0.02 * e[:, :n // 7]
    cfg = AggConfig(kind="cl_tc_sia", q=78, err_sq_mode="kernel")
    trees = [AggTree(parent=tuple(PS if i == 0 else (i - 1) // (1 + p % 2)
                                  for i in range(7))) for p in range(4)]
    per_pod = compile_nested([[(tuple(range(7 * p, 7 * p + 7)), trees[p])
                               for p in range(4)], [((0, 1, 2, 3), None)]])
    assert not per_pod.clustered[0].uniform()
    outs = []
    for dev in (cuda, "cpu"):
        mesh = client_mesh(k, devices=[dev] * k)
        args = (list(g.to(dev)), list(e.to(dev)))
        h = hierarchical_ring_local(cfg, mesh, *args, list(pe.to(dev)), 1.3,
                                    sizes=(7, 4),
                                    global_mask=[gm.to(dev)] * k,
                                    participate=list(part.to(dev)))
        t = run_nested_segments_local(cfg, per_pod, mesh, *args,
                                      (list(pe.to(dev)),), 1.3,
                                      sizes=(7, 4),
                                      global_mask=[gm.to(dev)] * k)
        outs.append(h[0] + h[1] + h[2] + t[0] + t[1] + list(t[2][0]))
    for a, c in zip(*outs):
        _same_t(c, a)


@pytest.mark.parametrize("impl", ["scan", "hist"])
def test_sharded_tau_search_on_the_card(cuda, impl):
    """``threshold_for_topq`` over 8 shards on the card at d = 10^6,
    counting with ``ops.count_ge``: τ and counts equal the unsharded
    search on the CPU."""
    d, shards = 1_000_000, 8
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        d, dtype=np.float32))
    rounds = 3 if impl == "scan" else 2
    kw = dict(branch=64, rounds=rounds, tau_impl=impl, with_counts=True)
    want = sp.threshold_for_topq(x, 500, **kw)
    before = topq_threshold.count_ge_cuda.launches
    got = sp.threshold_for_topq(list(x.to(cuda).chunk(shards)), 500,
                                count_fn=ops.count_ge, **kw)
    if impl == "scan":
        assert (topq_threshold.count_ge_cuda.launches - before
                == shards * rounds)
    for a, b in zip(want, got):
        _same_t(a, b)


# ---------------------------------------------------------------------------
# the LM serving path (plain PyTorch on the card; no kernel of its own)
# ---------------------------------------------------------------------------

@pytest.fixture
def no_tf32(monkeypatch):
    """Full-f32 products on the card, as in the reference."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _lm_close(got, want, tol):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", [
    "granite-34b", "codeqwen1.5-7b", "glm4-9b", "phi4-mini-3.8b",
    "mixtral-8x7b", "llama4-scout-17b-a16e", "zamba2-1.2b",
    "internvl2-26b", "mamba2-130m", "musicgen-medium"])
def test_lm_smoke_arch_on_the_card_equals_the_cpu(cuda, no_tf32, arch):
    """Each SMOKE architecture in float32 from one generator's weights:
    ``forward``, ``prefill`` of all tokens but the last and ``decode_step``
    of the last (logits and caches) on the card = on the CPU to rtol =
    atol = 1e-3; on the card prefill and decode = ``forward`` to the
    reference test's 2e-2."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as lm
    from repro_torch.models.transformer import tree_leaves, tree_map
    cfg = get_config(arch, smoke=True)
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(2))
    out = {}
    for dev, p in (("cpu", p_cpu),
                   (cuda, tree_map(lambda a: a.to(cuda), p_cpu))):
        t = toks.to(dev)
        with torch.inference_mode():
            lo, aux = lm.forward(cfg, p, t)
            cache = lm.init_cache(cfg, 2, 16, dev)
            last, cache = lm.prefill(cfg, p, t[:, :-1], cache)
            step, cache = lm.decode_step(cfg, p, cache, t[:, -1], 11)
        out[str(dev)] = (lo, aux, last, step, tree_leaves(cache))
    card, cpu = out[str(cuda)], out["cpu"]
    for a, b in zip(card[:4] + tuple(card[4]), cpu[:4] + tuple(cpu[4])):
        _lm_close(a, b, 1e-3)
    _lm_close(card[2], card[0][:, -2], 2e-2)
    _lm_close(card[3], card[0][:, -1], 2e-2)


def test_lm_full_width_phi4_layer_on_the_card_equals_the_cpu(cuda, no_tf32):
    """One phi4-mini-3.8b layer at full width in float32 (3072 wide, 24
    query and 8 KV heads of 128, an 8192-wide SwiGLU) on 2 × 32 tokens:
    the card = the CPU to rtol = atol = 1e-4, and decode into its cache =
    the layer's own forward."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tr
    from repro_torch.models.transformer import tree_map
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b"), num_layers=1,
                              param_dtype="float32")
    p_card = tr._dense_layer_init(
        torch.Generator(device=cuda).manual_seed(0), cfg, torch.float32,
        cuda)
    p_cpu = tree_map(lambda a: a.cpu(), p_card)
    h = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        want, _, _ = tr._dense_layer(cfg, p_cpu, h)
        got, _, _ = tr._dense_layer(cfg, p_card, h.to(cuda))
        cache = {k: torch.zeros((2, 32, 8, 128), device=cuda)
                 for k in ("k", "v")}
        tr._dense_layer(cfg, p_card, h[:, :31].to(cuda), cache)
        step, _, _ = tr._dense_layer(cfg, p_card, h[:, 31:].to(cuda), cache,
                                     31)
    _lm_close(got, want, 1e-4)
    _lm_close(step[:, 0], got[:, 31], 1e-4)


# ---------------------------------------------------------------------------
# The LM train step on the card (plain PyTorch autograd + the level kernels)
# ---------------------------------------------------------------------------

TRAIN_FAMILIES = {"dense": "codeqwen1.5-7b", "moe": "mixtral-8x7b",
                  "ssm": "mamba2-130m", "hybrid": "zamba2-1.2b"}
TRAIN_VARIANTS = {
    "cl_sia": dict(mesh=(4, 1), kind="cl_sia", agg={}),
    "cl_sia 2x2": dict(mesh=(2, 2), kind="cl_sia", agg={}),
    "cl_tc_sia hist": dict(mesh=(4, 1), kind="cl_tc_sia",
                           agg=dict(topq_impl="threshold", tau_impl="hist",
                                    hist_rounds=2)),
    "hierarchical": dict(mesh=(2, 2, 1), kind="cl_sia", agg={},
                         topology="hierarchical"),
    "cohorts": dict(mesh=(4, 1), kind="cl_sia", agg={}, cohorts=2),
}


def _same_support(got, want, what):
    """``ef == 0`` equal but for swaps of two candidates tied at the Q-th
    magnitude (the left-behind magnitudes agree to 1e-5)."""
    got = got.float().cpu().reshape(-1, got.shape[-1])
    want = want.float().cpu().reshape(-1, want.shape[-1])
    for k in range(got.shape[0]):
        a = want[k][(got[k] == 0) & (want[k] != 0)].abs().sort().values
        b = got[k][(want[k] == 0) & (got[k] != 0)].abs().sort().values
        if a.numel() or b.numel():
            assert a.numel() == b.numel(), (what, k, a.numel(), b.numel())
            gap = float((a - b).abs().max() / a.max())
            assert gap <= 1e-5, (what, k, gap)


@pytest.mark.parametrize("variant", list(TRAIN_VARIANTS))
@pytest.mark.parametrize("family", list(TRAIN_FAMILIES))
def test_train_step_on_the_card_equals_the_cpu(cuda, no_tf32, family,
                                               variant):
    """Each SMOKE family in float32 on ranks of the card against the same
    ranks on the CPU, 3 steps, each from the CPU's state before it: the
    whole step's loss to rtol 1e-5 (under exact Top-Q also bits and nnz
    equal, the transmitted support equal but for ties, and the step's
    change of master and params the CPU's to 1e-3 of its scale, with one
    step's slack only where a tie swapped the support; a threshold τ moves
    with the last bits of the gradients, so there only the loss), and phases 2–3 on the card fed the CPU's
    gradient columns: EF, stage EF, ``tcs_prev``, bits and nnz = the CPU's
    bit for bit, ``err_sq`` to 1e-6, and the elementwise optimizer's
    master, moments and params to rtol 1e-6 (torch's CPU and CUDA kernels
    round its float32 arithmetic apart in the last bits); the
    level kernels launch as many times as the plan has levels per model
    column."""
    import dataclasses
    import math as _math
    from _torch_train import (assert_step_close, port_leaves,
                              loose_coordinates)
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import AggConfig, AggKind
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import TrainConfig, build_train_step, init_state
    from repro_torch.train.state import state_to
    v = TRAIN_VARIANTS[variant]
    cfg = dataclasses.replace(get_config(TRAIN_FAMILIES[family], smoke=True),
                              param_dtype="float32")
    tc = TrainConfig(agg=AggConfig(kind=AggKind(v["kind"]), q=1, **v["agg"]),
                     q_frac=0.05, agg_dtype="float32", ef_dtype="float32")
    axes = ("pod", "data", "model") if len(v["mesh"]) == 3 else ("data",
                                                                 "model")
    n = _math.prod(v["mesh"])
    coh, topo = v.get("cohorts", 1), v.get("topology")
    meshes = {d: make_mesh(v["mesh"], axes, [d] * n)
              for d in ("cpu", "cuda:0")}
    steps = {d: build_train_step(cfg, tc, m, topology=topo, cohorts=coh)
             for d, m in meshes.items()}
    cpu_step, card_step = steps["cpu"], steps["cuda:0"]
    st = init_state(cfg, tc, meshes["cpu"], torch.Generator().manual_seed(0),
                    topology=topo, cohorts=coh)
    gen = torch.Generator().manual_seed(1)
    shape = (coh, 8, 16) if coh > 1 else (8, 16)
    for s in range(3):
        toks = torch.randint(0, cfg.vocab_size, shape, generator=gen)
        part = [1.0] * cpu_step.k_dp
        part[-1] = 0.0 if s == 1 else 1.0
        batch = {"tokens": toks, "labels": toks.roll(-1, -1),
                 "participate": torch.tensor(part)}
        before = [fn.launches for fn in level.KERNELS]
        card, mc = card_step(state_to(st, cuda),
                             {k: x.to(cuda) for k, x in batch.items()})
        torch.cuda.synchronize()
        grown = {fn.__name__.replace("_cuda", ""): fn.launches - b
                 for fn, b in zip(level.KERNELS, before)
                 if fn.launches - b}
        assert grown == train_launches(card_step), (grown, s)
        plain, w, p = cpu_step.round_inputs(batch)
        cols, loss = cpu_step.phase1(st, plain)
        new, m = cpu_step.finish(st, cols, loss, w, p)
        torch.testing.assert_close(mc["loss"].cpu(), m["loss"], rtol=1e-5,
                                   atol=0)
        if tc.agg.topq_impl == "exact":
            for key in ("agg_bits", "agg_nnz"):
                assert torch.equal(mc[key].cpu(), m[key]), key
            what = f"{family} {variant} step {s}"
            _same_support(card.ef, new.ef, what)
            for a, b in zip(card.stage_ef or (), new.stage_ef or ()):
                _same_support(a, b, what + " stage EF")
            # the step's change of master and params = the CPU's, but at
            # coordinates a tie swapped (each moves by up to one step)
            old = port_leaves(st)
            got, want = port_leaves(card), port_leaves(new)
            assert_step_close(
                what, old, got, want, 1e-3,
                loose_coordinates(cpu_step, old, got, want),
                3 * tc.opt.lr * float(m["lr_scale"].max()))
        card2, mc2 = card_step.finish(
            state_to(st, cuda), [[c.to(cuda) for c in row] for row in cols],
            loss.to(cuda), w, p)
        for (pa, a), (pb, b) in zip(_flatten_with_paths(card2),
                                    _flatten_with_paths(new)):
            assert pa == pb, (s, pa, pb)
            if pa[0] in (".ef", ".stage_ef", ".tcs_prev", ".step"):
                _same(a, b)                     # phase 2: bit for bit
            else:                               # phase 3: the optimizer
                scale = float(b.float().abs().max())
                torch.testing.assert_close(a.cpu(), b, rtol=1e-6,
                                           atol=1e-6 * scale)
        for key in ("agg_bits", "agg_nnz"):
            _same(mc2[key], m[key])
        torch.testing.assert_close(mc2["agg_err_sq"].cpu(), m["agg_err_sq"],
                                   rtol=1e-6, atol=0)
        st = new


def test_dry_run_predicts_the_card_peak_of_a_decode_cell(cuda):
    """``launch/dryrun.dry_run_cell`` on fake ``cuda:0`` tensors against
    the card: mamba2-130m × long_500k at full size on one card, its
    predicted device peak within ±1 % of the bytes the step adds to the
    card at its peak (its arguments included)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as lm
    from repro_torch.train.step import build_serve_step
    cfg, shape = get_config("mamba2-130m"), SHAPES["long_500k"]
    rec = dryrun.dry_run_cell(cfg, shape, make_mesh(
        (1, 1), ("data", "model"), ["cuda:0"]))
    assert rec["device"] == "cuda:0"
    gen = torch.Generator(device=cuda).manual_seed(0)
    # a process's first GEMM allocates cuBLAS's workspace, which then stays:
    # make it with the SMOKE config's step, so the reading holds the step's
    # own bytes (chip_smoke's earlier phases do the same for phase 13)
    small = get_config("mamba2-130m", smoke=True)
    build_serve_step(small, None)(
        lm.init_params(small, gen, cuda), lm.init_cache(small, 1, 8, cuda),
        torch.zeros((1,), dtype=torch.int32, device=cuda), 7)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(cuda)
    params = lm.init_params(cfg, gen, cuda)
    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len, cuda)
    tok = torch.zeros((shape.global_batch,), dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    nxt, _ = build_serve_step(cfg, None)(params, cache, tok,
                                          shape.seq_len - 1)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated(cuda) - base
    assert nxt.shape == (shape.global_batch,)
    assert abs(rec["device_peak_bytes"] / measured - 1) <= 0.01, (
        rec["device_peak_bytes"], measured)


@pytest.mark.parametrize("opt,topq", [("sgd", "exact"), ("adamw", "exact"),
                                      ("adamw", "threshold")])
def test_placed_state_on_a_mesh_of_the_card_and_the_cpu(cuda, no_tf32, opt,
                                                        topq):
    """Chip_smoke phase 14 at SMOKE size: mamba2-130m in float32 on 4 × 1
    ranks ``cuda:0, cpu, cpu, cpu``, 3 CL-SIA steps: every piece on its
    rank's device; each step's phases 2–3 also on ``["cuda:0"] * 4`` from
    the same state and gradient columns — EF, bits and nnz bit for bit,
    master, moments and params bit for bit under SGD and to 1e-6 of their
    scale under AdamW; the card's level kernels launch once per level (the
    CPU ranks run the plain versions). Under threshold Top-Q the card's
    peak over the first step is also held within ±1 % of the dry run's
    prediction for ``cuda:0``; exact Top-Q takes a stable sort on these
    short segments, whose scratch inside the sort a fake run does not
    see (phase 14's segments, over 2^22, take the per-row select)."""
    import dataclasses
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.algorithms import AggConfig, AggKind
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, build_train_step, init_state
    from repro_torch.train.state import (RankPieces, gather_state,
                                         state_to)
    from repro_torch.train.step import rank_device
    cfg = dataclasses.replace(get_config("mamba2-130m", smoke=True),
                              param_dtype="float32")
    agg = (dict(topq_impl="threshold", tau_impl="hist", hist_rounds=2)
           if topq == "threshold" else {})
    tc = TrainConfig(agg=AggConfig(kind=AggKind.CL_SIA, q=1, **agg),
                     opt=OptConfig(name=opt, lr=1e-2), q_frac=0.05,
                     agg_dtype="float32", ef_dtype="float32")
    mixed = make_mesh((4, 1), ("data", "model"),
                      ["cuda:0", "cpu", "cpu", "cpu"])
    card = make_mesh((4, 1), ("data", "model"), ["cuda:0"] * 4)
    pred = dryrun.dry_run_cell(cfg, ShapeSpec("placed", 16, 8, "train"),
                               mixed, tc)
    step, check = build_train_step(cfg, tc, mixed), build_train_step(
        cfg, tc, card)
    want = train_launches(step)
    # a first step warms cuBLAS's workspace, which then stays
    warm = init_state(cfg, tc, card, torch.Generator(device=cuda))
    toks = torch.zeros((8, 16), dtype=torch.int64, device=cuda)
    check(warm, {"tokens": toks, "labels": toks})
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(cuda)
    state = init_state(cfg, tc, mixed,
                       torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for s in range(3):
        for leaf in (state.master, state.opt.m, state.opt.v, state.ef):
            if leaf is not None:
                assert isinstance(leaf, RankPieces)
                assert [p.device for p in leaf.pieces] == [
                    rank_device(mixed, k) for k in range(4)]
        toks = torch.randint(0, cfg.vocab_size, (8, 16), generator=gen)
        batch = {"tokens": toks.to(cuda), "labels": toks.roll(-1, -1).to(
            cuda)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda)
        before = [fn.launches for fn in level.KERNELS]
        plain, w, p = step.round_inputs(batch)
        cols, loss = step.phase1(state, plain)
        kept = [[c.to("cpu", copy=True) for c in row] for row in cols]
        old = gather_state(state, "cpu")
        new, m = step.finish(state, cols, loss, w, p)
        torch.cuda.synchronize()
        if s == 0 and topq == "threshold":
            measured = torch.cuda.max_memory_allocated(cuda) - base
            assert abs(pred["device_peak_bytes"] / measured - 1) <= 0.01, (
                pred["device_peak_bytes"], measured)
        grown = {fn.__name__.replace("_cuda", ""): fn.launches - b
                 for fn, b in zip(level.KERNELS, before)
                 if fn.launches - b}
        assert grown == want, (grown, want)
        del cols
        ref, mr = check.finish(state_to(old, cuda),
                               [[c.to(cuda) for c in row] for row in kept],
                               loss.to(cuda), w, p)
        got = gather_state(new, "cpu")
        for (pa, a), (pb, b) in zip(_flatten_with_paths(got),
                                    _flatten_with_paths(ref)):
            assert pa == pb
            if pa[0] in (".ef", ".step") or opt == "sgd":
                _same(a, b)
            else:
                scale = float(b.float().abs().max())
                torch.testing.assert_close(a, b.cpu(), rtol=1e-6,
                                           atol=1e-6 * scale)
        for key in ("agg_bits", "agg_nnz"):
            _same(m[key], mr[key])
        state = new


# name → (arch, config fields, mesh, fsdp_compute)
TP_CASES = {
    "dense tied": ("phi4-mini-3.8b", dict(tie_embeddings=True,
                                          vocab_size=500), (4, 2), False),
    "dense untied gqa": ("granite-34b", {}, (4, 2), False),
    "moe": ("mixtral-8x7b", {}, (4, 2), False),
    "ssm": ("mamba2-130m", {}, (4, 2), False),
    "hybrid": ("zamba2-1.2b", {}, (4, 2), False),
    "vlm": ("internvl2-26b", {}, (4, 2), False),
    "audio": ("musicgen-medium", {}, (4, 2), False),
    "dense fsdp_compute": ("codeqwen1.5-7b", {}, (4, 2), True),
    "2x4 dense": ("phi4-mini-3.8b", {}, (2, 4), False),
}


def _tp_setup(name):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.algorithms import AggConfig, AggKind
    from repro_torch.train import TrainConfig
    arch, over, mesh, fsdp = TP_CASES[name]
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype="float32", **over)
    tc = TrainConfig(agg=AggConfig(kind=AggKind.CL_SIA, q=1), q_frac=0.05,
                     agg_dtype="float32", ef_dtype="float32",
                     fsdp_compute=fsdp)
    return cfg, tc, mesh


def _tp_batch(cfg, gen, device):
    toks = torch.randint(0, cfg.vocab_size, (8, 16), generator=gen)
    batch = {"tokens": toks, "labels": toks.roll(-1, -1)}
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = torch.randn(8, 16, cfg.d_model,
                                               generator=gen)
        batch["frontend_mask"] = torch.rand(8, 16, generator=gen) < 0.3
    elif cfg.frontend == "audio":
        batch["frontend_embeds"] = 0.1 * torch.randn(8, 16, cfg.d_model,
                                                     generator=gen)
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.parametrize("name", list(TP_CASES))
def test_split_step_on_the_card_equals_the_cpu(cuda, no_tf32, name):
    """The CPU test ``test_torch_train_tp.py::test_split_step_equals_the_
    reference`` on the card: phase 1 split over ``model`` (tensor-parallel,
    or batch over model for SSM, hybrid and ``fsdp_compute``) on ranks of
    ``cuda:0`` against the same split step on ranks of the CPU, each of 2
    steps from the CPU's state before it: the loss to rtol 1e-5, the
    support equal but for tie swaps, the change of master and params to
    1e-3 of its scale, the level kernels launched once per level and
    column."""
    import math as _math
    from _torch_train import (assert_step_close, loose_coordinates,
                              port_leaves)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import build_train_step, init_state
    from repro_torch.train.state import state_to
    cfg, tc, shape = _tp_setup(name)
    n = _math.prod(shape)
    steps = {d: build_train_step(cfg, tc, make_mesh(
        shape, ("data", "model"), [d] * n)) for d in ("cpu", "cuda:0")}
    cpu_step, card_step = steps["cpu"], steps["cuda:0"]
    st = init_state(cfg, tc, cpu_step.mesh, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for s in range(2):
        batch = _tp_batch(cfg, gen, "cpu")
        assert card_step.phase1_form(batch) == cpu_step.phase1_form(batch) \
            != "whole"
        before = [fn.launches for fn in level.KERNELS]
        card, mc = card_step(state_to(st, cuda),
                             {k: v.to(cuda) for k, v in batch.items()})
        torch.cuda.synchronize()
        grown = {fn.__name__.replace("_cuda", ""): fn.launches - b
                 for fn, b in zip(level.KERNELS, before)
                 if fn.launches - b}
        assert grown == train_launches(card_step), (grown, s)
        new, m = cpu_step(st, batch)
        torch.testing.assert_close(mc["loss"].cpu(), m["loss"], rtol=1e-5,
                                   atol=0)
        what = f"{name} step {s}"
        _same_support(card.ef, new.ef, what)
        old = port_leaves(st)
        got, want = port_leaves(card), port_leaves(new)
        assert_step_close(what, old, got, want, 1e-3,
                          loose_coordinates(cpu_step, old, got, want),
                          3 * tc.opt.lr * float(m["lr_scale"].max()))
        st = new


def test_split_columns_on_the_card_equal_the_whole_model_columns(cuda,
                                                                 no_tf32):
    """Chip_smoke phase 15 (a) at SMOKE size in float32: phi4 (tied, with
    pad slots) on 2 × 2 ranks of ``cuda:0``, every leaf but the norms
    split: each client's tensor-parallel columns against its whole-model
    autograd gradient through ``local_flatten(·, m)`` (2e-6 of the
    largest entry, the loss to 1e-6), and the step fed the TP columns
    against the same step fed the whole-model columns (1e-3 of its
    change's scale, ``assert_step_close``'s rule)."""
    from _torch_train import (assert_step_close, loose_coordinates,
                              port_leaves)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import build_train_step, init_state
    cfg, tc, _ = _tp_setup("dense tied")
    step = build_train_step(cfg, tc, make_mesh((2, 2), ("data", "model"),
                                               ["cuda:0"] * 4))
    st = init_state(cfg, tc, step.mesh,
                    torch.Generator(device=cuda).manual_seed(0))
    plain, w, p = step.round_inputs(
        _tp_batch(cfg, torch.Generator().manual_seed(2), cuda))
    assert step.phase1_form(plain) == "tensor_parallel"
    tp_cols, whole_cols, tp_loss, whole_loss = [], [], [], []
    for k in range(step.k_dp):
        cols, loss = step.client_cols(st.params, plain, k)
        g, want = step.client_grad(st.params, plain, k)
        ref_k = [step.layout.local_flatten(g, m_, torch.float32)
                 for m_ in range(step.m)]
        torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
        for a, b in zip(cols, ref_k):
            assert float((a - b).abs().max() / b.abs().max()) <= 2e-6
        tp_cols.append(cols)
        whole_cols.append(ref_k)
        tp_loss.append(loss)
        whole_loss.append(want)
    got, _ = step.finish(st, tp_cols, step._mean_loss(tp_loss), w, p)
    want, m = step.finish(st, whole_cols, step._mean_loss(whole_loss), w, p)
    old, a, b = port_leaves(st), port_leaves(got), port_leaves(want)
    assert_step_close("phase 15 (a) at SMOKE size", old, a, b, 1e-3,
                      loose_coordinates(step, old, a, b),
                      3 * tc.opt.lr * float(m["lr_scale"]))


@pytest.mark.parametrize("name", ["dense tied", "ssm"])
def test_split_step_on_a_mesh_of_the_card_and_the_cpu(cuda, no_tf32, name):
    """Chip_smoke phase 15 (b) at (4, 2): each client's rank 0 on the card
    and rank 1 on the CPU, so the tensor-parallel sums (or the batch over
    model's reduction) cross devices, with the layer remat on: 2 steps,
    each from the all-card step's state before it, equal the all-card
    steps to 1e-6 of the change's scale and the loss to 1e-5."""
    from _torch_train import (assert_step_close, loose_coordinates,
                              port_leaves)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import (build_train_step, init_state,
                                   state_shardings)
    from repro_torch.train.state import gather_state, state_to
    from repro_torch.train.step import place_state
    cfg, tc, shape = _tp_setup(name)
    assert cfg.remat
    mixed = make_mesh(shape, ("data", "model"), ["cuda:0", "cpu"] * 4)
    card = make_mesh(shape, ("data", "model"), ["cuda:0"] * 8)
    step, check = (build_train_step(cfg, tc, mixed),
                   build_train_step(cfg, tc, card))
    specs = state_shardings(cfg, tc, mixed)
    st = init_state(cfg, tc, card, torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator().manual_seed(3)
    for s in range(2):
        batch = _tp_batch(cfg, gen, cuda)
        old = state_to(st, "cpu")
        new, m = step(place_state(old, mixed, specs), batch)
        st, mc = check(st, batch)
        torch.testing.assert_close(m["loss"].cpu(), mc["loss"].cpu(),
                                   rtol=1e-5, atol=0)
        o, got, want = (port_leaves(old), port_leaves(gather_state(
            new, "cpu")), port_leaves(state_to(st, "cpu")))
        assert_step_close(f"{name} mixed step {s}", o, got, want, 1e-6,
                          loose_coordinates(check, o, got, want),
                          3 * tc.opt.lr * float(mc["lr_scale"]))


SPLIT_LAYOUTS = {"heads over model": ((2, 2), 2),
                 "seq over model": ((1, 3), 1),
                 "split-K over data": ((2, 2), 1)}


@pytest.mark.parametrize("layout", list(SPLIT_LAYOUTS))
def test_split_serving_on_ranks_of_the_card_equals_the_whole_form(
        cuda, no_tf32, layout):
    """The CPU test ``test_torch_serve_split.py`` on ranks of ``cuda:0``:
    SMOKE phi4-mini and mixtral in float32, the split prefill and each
    split decode step (teacher-forced) against the whole form on the card,
    rtol = atol = 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as lm
    from repro_torch.models import serve_split
    shape, batch = SPLIT_LAYOUTS[layout]
    mesh = make_mesh(shape, ("data", "model"),
                     ["cuda:0"] * math.prod(shape))
    for arch, s, gen in (("phi4-mini-3.8b", 12, 6), ("mixtral-8x7b", 32, 18)):
        cfg = get_config(arch, smoke=True)
        params = lm.init_params(cfg, torch.Generator().manual_seed(0), cuda)
        toks = torch.randint(0, cfg.vocab_size, (batch, s + gen),
                             generator=torch.Generator().manual_seed(7)
                             ).to(cuda)
        sp = serve_split.ServeSplit(cfg, mesh, batch, s + gen)
        placed = serve_split.place_params(params, cfg, mesh)
        with torch.inference_mode():
            cache = lm.init_cache(cfg, batch, s + gen, cuda)
            split = sp.init_cache()
            want, cache = lm.prefill(cfg, params, toks[:, :s], cache)
            got, split = sp.prefill(placed, split, toks[:, :s])
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            for i in range(gen - 1):
                want, cache = lm.decode_step(cfg, params, cache,
                                             toks[:, s + i], s + i)
                got, split = sp.decode(placed, split, toks[:, s + i], s + i)
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                                           msg=f"{arch} {layout} {i}")


def test_dry_run_predicts_the_peak_of_a_split_serving_step(cuda):
    """``dry_run_cell`` of a split prefill and decode on 2 × 2 ranks of
    ``cuda:0`` (phi4-mini at full widths, 4 of 32 layers, bf16, batch 4):
    the larger predicted device peak within ±1 % of the bytes the split
    run (placed params, cache, prefill and decode steps) adds to the card
    at its peak (chip_smoke phase 16 (a) at full depth)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as lm
    from repro_torch.models import serve_split
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b"), num_layers=4)
    mesh = make_mesh((2, 2), ("data", "model"), ["cuda:0"] * 4)
    b, s, gen = 4, 256, 4
    pred = max(dryrun.dry_run_cell(cfg, ShapeSpec(k, n, b, k), mesh)[
        "device_peak_bytes"] for k, n in (("prefill", s), ("decode", s + gen)))
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            cuda)
    toks = torch.randint(0, cfg.vocab_size, (b, s + gen), device=cuda)
    # a process's first GEMM allocates cuBLAS's workspace, which then stays
    with torch.inference_mode():
        lm.prefill(cfg, params, toks[:, :8], lm.init_cache(cfg, b, 8, cuda))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    sp = serve_split.ServeSplit(cfg, mesh, b, s + gen)
    placed = serve_split.place_params(params, cfg, mesh)
    with torch.inference_mode():
        cache = sp.init_cache()
        _, cache = sp.prefill(placed, cache, toks[:, :s])
        for i in range(gen - 1):
            _, cache = sp.decode(placed, cache, toks[:, s + i], s + i)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated(cuda) - base
    assert abs(pred / measured - 1) <= 0.01, (pred, measured)
