"""CUDA level kernels against their plain PyTorch versions.

Needs a CUDA card and nvcc: every test takes the ``cuda`` fixture, which
skips where there is no card. Run on the card with
``python -m pytest -m gpu tests/test_torch_gpu.py``. Each kernel must equal
its plain version run on the CPU on the same inputs, bit for bit, for every
float and integer output (the CPU version is the one the parity tests hold
against the JAX package). The τ-search kernels are held the same way, at
the histogram's shared-memory and global-atomics branches and on
magnitudes placed on the histogram's bin edges.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import sparsify as sp
from repro_torch.kernels import level, ops, ref

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
