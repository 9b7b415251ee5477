"""Exact Top-Q on long rows (``repro_torch.core.sparsify``): rows of at
least ``_SELECT_D`` entries select the support through the q-th largest
magnitude instead of a full sort (the LM train step's segments run to
2·10^8 entries a row). The support must be the stable descending sort's,
which is jitted ``repro``'s ``lax.top_k``: held here bit for bit against
the reference (row by row) on rows with ties at the q-th magnitude,
zeros, ±inf and NaN, in float32 and bfloat16, with the selection
threshold lowered so small rows take it, and the sort path too; and the
compact wire of long rows against its sort path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsify as ref_sp
from repro_torch.core import sparsify as sp

torch.set_num_threads(1)


def _rows(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 4097)).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 4) / 4                # many equal magnitudes
    elif kind == "zeros":
        x[:, ::3] = 0.0
        x[1] = 0.0                             # fewer nonzeros than q
        x[1, :5] = 1.0
    elif kind == "inf":
        x[0, [7, 90, 1000]] = np.inf
        x[2, [3, 4]] = -np.inf
    elif kind == "nan":
        x[0, [11, 12]] = np.nan
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q", [1, 17, 600, 4096])
@pytest.mark.parametrize("kind", ["plain", "ties", "zeros", "inf", "nan"])
def test_select_path_equals_the_reference(monkeypatch, kind, q, dtype):
    monkeypatch.setattr(sp, "_SELECT_D", 64)
    x = _rows(kind, q)
    xj = jnp.asarray(x).astype(dtype)
    want_mask = np.asarray(jax.jit(jax.vmap(
        lambda a: ref_sp.topq_mask(a, q)))(xj)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda a: ref_sp.topq(a, q)))(xj))
    # the same bits in both packages (their casts of NaN differ)
    bits = np.int32 if dtype == "float32" else np.int16
    t = torch.from_numpy(np.asarray(xj).view(bits).copy()).view(
        getattr(torch, dtype))
    got_mask = sp.topq_mask(t, q).float().numpy()
    got = sp.topq(t, q).view(getattr(torch, bits.__name__)).numpy()
    assert np.array_equal(got_mask, want_mask)
    assert np.array_equal(got, want.view(bits))
    # the sort path (the default for these widths) agrees too
    monkeypatch.setattr(sp, "_SELECT_D", 1 << 30)
    assert np.array_equal(sp.topq_mask(t, q).float().numpy(), want_mask)


@pytest.mark.parametrize("nnz", [0, 5, 40, 300])
def test_compact_of_long_rows_equals_the_sort(monkeypatch, nnz):
    """``compact`` of rows past ``_SELECT_D`` (read from their nonzero
    positions) = the sort path: the first q nonzeros in index order, the
    one-past-end index in unused slots, the full count."""
    rng = np.random.default_rng(nnz)
    x = np.zeros((2, 3, 1000), np.float32)
    for r in range(2):
        for c in range(3):
            pos = rng.choice(1000, nnz, replace=False)
            x[r, c, pos] = rng.standard_normal(nnz)
    t = torch.as_tensor(x)
    want = sp.compact(t, 40)
    monkeypatch.setattr(sp, "_SELECT_D", 64)
    got = sp.compact(t, 40)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
