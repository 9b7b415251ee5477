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
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import sparsify as sp
from repro_torch.kernels import (chain_accum, level, ops, ref, sparsify_ef,
                                 topq_threshold)

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
    assert grown == [0, 0, 0, 2, 2, 2]


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
    assert grown == [2, 0, 2, 2, 2, 0]


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
