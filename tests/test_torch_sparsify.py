"""Exact Top-Q family of the port against :mod:`repro.core.sparsify`.

Inputs are made with numpy from a seed and fed to both packages; every
output must be equal bit for bit (tolerance: none). The tie-heavy inputs
check that the port keeps ``lax.top_k``'s tie order (lower index first).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsify as jsp
from repro_torch.core import sparsify as tsp

torch.set_num_threads(1)

D = 257


def _x(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal(shape).astype(np.float32)
    # tie-heavy: few distinct magnitudes, both signs, many zeros
    return rng.integers(-3, 4, shape).astype(np.float32)


def _same(a, b):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("q", [0, 1, 7, 64, D - 1, D, D + 5])
def test_topq_and_mask_match_reference(kind, q):
    x = _x(kind, (D,))
    _same(jax.jit(jsp.topq, static_argnums=1)(x, q),
          tsp.topq(torch.from_numpy(x), q))
    _same(jax.jit(jsp.topq_mask, static_argnums=1)(x, q),
          tsp.topq_mask(torch.from_numpy(x), q))


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_topq_rows_match_vmapped_reference(kind):
    x = _x(kind, (6, D), seed=3)
    q = 19
    _same(jax.vmap(lambda r: jsp.topq(r, q))(x),
          tsp.topq(torch.from_numpy(x), q))
    _same(jax.vmap(lambda r: jsp.topq_mask(r, q))(x),
          tsp.topq_mask(torch.from_numpy(x), q))


def test_tie_order_keeps_lower_index():
    x = np.zeros(16, np.float32)
    x[[2, 5, 9, 11]] = [1.0, -1.0, 1.0, -1.0]
    got = tsp.topq_mask(torch.from_numpy(x), 2).numpy()
    assert np.flatnonzero(got).tolist() == [2, 5]
    _same(jsp.topq_mask(jnp.asarray(x), 2), torch.from_numpy(got))


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_dynamic_budgets_match_reference(kind):
    x = _x(kind, (7, D), seed=5)
    qb = np.array([0, 1, 13, D - 1, D, D + 9, 40], np.int32)
    _same(jax.vmap(jsp.topq_dynamic)(x, qb),
          tsp.topq_dynamic(torch.from_numpy(x), torch.from_numpy(qb)))
    _same(jax.vmap(jsp.topq_mask_dynamic)(x, qb),
          tsp.topq_mask_dynamic(torch.from_numpy(x), torch.from_numpy(qb)))


def test_support_union_nnz_match_reference():
    x = _x("ties", (D,), seed=7)
    y = _x("ties", (D,), seed=8)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    _same(jsp.support(x), tsp.support(tx))
    _same(jsp.mask_union(jsp.support(x), jsp.support(y)),
          tsp.mask_union(tsp.support(tx), tsp.support(ty)))
    assert int(jsp.nnz(x)) == int(tsp.nnz(tx))
    assert tsp.nnz(tx).dtype == torch.int32
