"""Plain PyTorch versions of the scalar ``[d]`` kernels against the JAX
package.

Each plain version in ``repro_torch.kernels.ref`` (``ref_count_ge``,
``ref_sparsify_ef``, ``ref_chain_accum``, ``ref_cl_fuse``,
``ref_count_ge_fused``) is held bit for bit (tolerance: none, zeros' signs
included) against ``repro.kernels.ref`` under ``jax.jit`` and against the
Pallas kernel it stands for, run through ``repro.kernels.ops`` with
``mode="always"`` (interpret mode on the CPU), at the shapes of
``tests/test_kernels.py`` (d = 63, 1024, 8192, 8209, 65539) in float32
and bfloat16. The inputs are made with numpy from a seed, cast to the
dtype once by JAX, and handed to the port as the same bits. The variants:
τ ≤ 0 and τ = +inf among the candidates of both counts (the Pallas
kernels pad each row to whole tiles and subtract the pad for τ ≤ 0; the
port pads nothing), ``include_gamma`` on and off, ``mask_in`` on and off
(off is no mask for the port and a zero mask for the reference). The
dispatch modes and the 1-D τ search that counts with ``ops.count_ge`` are
held too; the CUDA kernels themselves are held against these plain
versions in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsify as jsp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import sparsify as tsp
from repro_torch.kernels import level as tlevel
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

SHAPES = [63, 1024, 8192, 8192 + 17, 65536 + 3]
DTYPES = ["float32", "bfloat16"]
W, TAU, P = 1.7, 1.2, 0.6


def _inputs(d: int, dtype: str, seed: int):
    """→ (JAX arrays, torch tensors) with the same bits."""
    rng = np.random.default_rng(seed)
    f = lambda s: (rng.standard_normal(d) * s).astype(np.float32)  # noqa: E731
    x = dict(g=f(1.0), e=f(0.3), gin=f(1.0) * (rng.random(d) < 0.3),
             mask=(rng.random(d) < 0.05).astype(np.float32))
    jx = {k: jnp.asarray(v, jnp.float32) for k, v in x.items()}
    for k in ("g", "e", "gin"):
        jx[k] = jx[k].astype(dtype)
    return jx, {k: _torch(v) for k, v in jx.items()}


def _torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(want, got):
    assert _torch(want).dtype == got.dtype, (want.dtype, got.dtype)
    assert tuple(want.shape) == tuple(got.shape)
    np.testing.assert_array_equal(_bits(want), _bits(got))


def _taus(n: int, seed: int, *, shuffled: bool) -> np.ndarray:
    """Candidates over the operand's range with τ = −1, 0, +inf and a tie."""
    rng = np.random.default_rng(seed)
    taus = np.abs(rng.standard_normal(n)).astype(np.float32) * 1.5
    taus[:4] = [-1.0, 0.0, np.inf, taus[5]]
    return rng.permutation(taus) if shuffled else np.sort(taus)


def _check_all(want: tuple, pallas: tuple, got: tuple):
    assert len(want) == len(pallas) == len(got)
    for j, p, t in zip(want, pallas, got):
        _same(j, t)
        _same(p, t)


@pytest.mark.parametrize("d", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_mask", [False, True])
def test_sparsify_ef_plain_matches_pallas_and_ref(d, dtype, with_mask):
    jx, tx = _inputs(d, dtype, seed=d)
    jmask = jx["mask"] if with_mask else jnp.zeros((d,), jnp.float32)
    args = (jx["g"], jx["e"], jmask, np.float32(W), np.float32(TAU))
    want = jax.jit(jref.ref_sparsify_ef)(*args)
    pallas = jops.sparsify_ef(*args, mode="always")
    got = tref.ref_sparsify_ef(tx["g"], tx["e"],
                               tx["mask"] if with_mask else None, W, TAU)
    _check_all(want, pallas, got)
    assert got[2].dtype == torch.int32 and got[2].dim() == 0


@pytest.mark.parametrize("d", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cl_fuse_plain_matches_pallas_and_ref(d, dtype):
    jx, tx = _inputs(d, dtype, seed=d + 1)
    args = (jx["g"], jx["e"], jx["gin"], np.float32(W), np.float32(TAU))
    want = jax.jit(jref.ref_cl_fuse)(*args)
    pallas = jops.cl_fuse(*args, mode="always")
    got = tref.ref_cl_fuse(tx["g"], tx["e"], tx["gin"], W,
                           torch.tensor([TAU]))
    _check_all(want, pallas, got)


@pytest.mark.parametrize("d", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_chain_accum_plain_matches_pallas_and_ref(d, dtype):
    jx, tx = _inputs(d, dtype, seed=d + 2)
    want = jax.jit(jref.ref_chain_accum)(jx["gin"], jx["g"])
    pallas = jops.chain_accum(jx["gin"], jx["g"], mode="always")
    got = tref.ref_chain_accum(tx["gin"], tx["g"])
    _check_all(want, pallas, got)


@pytest.mark.parametrize("d", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_count_ge_plain_matches_pallas_and_ref(d, dtype):
    """Taus shuffled, with τ = −1 and 0 (every real element, no padding)
    and τ = +inf (none)."""
    jx, tx = _inputs(d, dtype, seed=d + 3)
    taus = _taus(32, d, shuffled=True)
    want = jax.jit(jref.ref_count_ge)(jx["g"], taus)
    pallas = jops.count_ge(jx["g"], taus, mode="always")
    got = tref.ref_count_ge(tx["g"], torch.from_numpy(taus))
    _check_all((want,), (pallas,), (got,))
    by_tau = dict(zip(taus.tolist(), got.tolist()))
    assert by_tau[-1.0] == by_tau[0.0] == d and by_tau[np.inf] == 0


@pytest.mark.parametrize("d", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("include_gamma", [False, True])
def test_count_ge_fused_plain_matches_pallas_and_ref(d, dtype,
                                                     include_gamma):
    """Nondecreasing taus (the reference's precondition) from −1 to +inf."""
    jx, tx = _inputs(d, dtype, seed=d + 4)
    taus = _taus(32, d + 1, shuffled=False)
    args = (jx["g"], jx["e"], jx["gin"], np.float32(W), np.float32(P), taus)
    want = jax.jit(lambda *a: jref.ref_count_ge_fused(
        *a, include_gamma=include_gamma))(*args)
    pallas = jops.count_ge_fused(*args, include_gamma=include_gamma,
                                 mode="always")
    got = tref.ref_count_ge_fused(tx["g"], tx["e"], tx["gin"], W,
                                  torch.tensor(P), torch.from_numpy(taus),
                                  include_gamma=include_gamma)
    _check_all((want,), (pallas,), (got,))
    assert int(got[0]) == int(got[1]) == d and int(got[-1]) == 0


def test_sparsify_ef_without_a_mask_equals_a_zero_mask():
    _, tx = _inputs(8209, "float32", seed=5)
    a = tref.ref_sparsify_ef(tx["g"], tx["e"], None, W, TAU)
    b = tref.ref_sparsify_ef(tx["g"], tx["e"], torch.zeros(8209), W, TAU)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(_bits(u), _bits(v))


def _scalar_calls(tx):
    taus = torch.from_numpy(_taus(16, 0, shuffled=True))
    return {
        "count_ge": ((tx["g"], taus), {}),
        "sparsify_ef": ((tx["g"], tx["e"], tx["mask"], W,
                         torch.tensor([TAU])), {}),
        "chain_accum": ((tx["gin"], tx["g"]), {}),
        "cl_fuse": ((tx["g"], tx["e"], tx["gin"], torch.tensor(W), TAU), {}),
        "count_ge_fused": ((tx["g"], tx["e"], tx["gin"], W, P, taus),
                           dict(include_gamma=True)),
    }


@pytest.mark.parametrize("dtype", DTYPES)
def test_scalar_ops_run_plain_versions_on_cpu_tensors(dtype):
    _, tx = _inputs(1000, dtype, seed=6)
    before = [k.launches for k in tlevel.COUNTED]
    for name, (args, kw) in _scalar_calls(tx).items():
        want = getattr(tref, "ref_" + name)(*args, **kw)
        want = want if isinstance(want, tuple) else (want,)
        for mode in ("auto", "never", "ref"):
            got = getattr(tops, name)(*args, **kw, mode=mode)
            got = got if isinstance(got, tuple) else (got,)
            for a, b in zip(want, got):
                np.testing.assert_array_equal(_bits(a), _bits(b))
        # "always" asks for the kernel: a CPU tensor raises rather than
        # run the plain version
        with pytest.raises(RuntimeError, match="always"):
            getattr(tops, name)(*args, **kw, mode="always")
    assert [k.launches for k in tlevel.COUNTED] == before


def test_scalar_wrappers_refuse_cpu_tensors():
    _, tx = _inputs(100, "float32", seed=7)
    taus = torch.ones(4)
    from repro_torch.kernels import chain_accum, sparsify_ef, topq_threshold
    calls = [lambda: chain_accum.chain_accum_cuda(tx["gin"], tx["g"]),
             lambda: chain_accum.cl_fuse_cuda(tx["g"], tx["e"], tx["gin"],
                                              W, TAU),
             lambda: sparsify_ef.sparsify_ef_cuda(tx["g"], tx["e"], None, W,
                                                  TAU),
             lambda: topq_threshold.count_ge_cuda(tx["g"], taus),
             lambda: topq_threshold.count_ge_fused_cuda(
                 tx["g"], tx["e"], None, W, P, taus)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(TypeError):
        topq_threshold.count_ge_cuda([1.0], taus)


@pytest.mark.parametrize("q", [10, 500, 5000])
def test_threshold_search_counting_with_ops_count_ge(q):
    """``threshold_for_topq(x, q, count_fn=ops.count_ge)`` on a 1-D x: the
    port's τ equals the jitted reference's counting with the Pallas kernel
    (interpret mode), bit for bit, and keeps at least q elements."""
    x = np.random.default_rng(7).standard_normal(50_000).astype(np.float32)
    want = jax.jit(lambda v: jsp.threshold_for_topq(
        v, q, count_fn=lambda m, t: jops.count_ge(m, t, mode="always")))(x)
    tx = torch.from_numpy(x)
    got = tsp.threshold_for_topq(
        tx, q, count_fn=lambda m, t: tops.count_ge(m, t))
    np.testing.assert_array_equal(_bits(want), _bits(got))
    assert q <= int((tx.abs() >= got).sum())
    np.testing.assert_array_equal(_bits(got),
                                  _bits(tsp.threshold_for_topq(tx, q)))
