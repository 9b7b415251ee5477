"""The index rules of the redesigned count kernels, mirrored in torch.

``csrc/tau_search.cu::hist_topq_level`` finds an element's two digits by
an estimate checked with exact comparisons, and ``csrc/topq_threshold.cu::
count_ge`` finds an element's rank by a table over the bit patterns of
|x|. Neither kernel runs here (no card), so this file mirrors both rules
with the kernels' float ops and holds the mirrors, integer for integer
(tolerance: none), against three references on the same numpy inputs: the
port's plain versions (``repro_torch.core.sparsify._hist_digits``,
``repro_torch.kernels.ref.ref_count_ge``) and the JAX package's jitted
``repro.core.sparsify._hist_digits`` and ``count_ge``.

* The digit rule: d1 ≈ (m − tau1[0])·inv1 + 1 and d2 ≈ (m − nl)·inv2,
  clamped to 0..b, confirmed against the bracket's bounds and candidates
  ``fma(w2e, j, nl)``, stepped at most ``K_STEPS`` times, else the binary
  searches; a lane whose tables break the rule's conditions searches; a NaN
  magnitude takes bracket b, digit 0. F is counted by its complement for
  r ≥ 1. The test fails if an element's estimate is more than K_STEPS off
  and the rule did not take the search.
* The rank table: 4096 buckets over the patterns from the smallest positive
  finite τ to the largest; below → #{τ ≤ 0}, above → #{τ < +inf} (all for
  +inf, none for NaN), inside a bucket → its first pattern's rank plus a
  binary search over the taus inside it.

Inputs: magnitudes on the histogram's bin edges and one ulp either side,
an all-zero operand (the tables' zero-width floor), NaN, ±inf, ±0 and
subnormals; taus on the table's bucket boundaries, −1, 0, +inf, NaN and
ties, B ∈ {1, 64, 4095}, rows in float32 and bfloat16.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsify as jsp
from repro_torch.core import sparsify as tsp
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

K_STEPS = 2                       # tau_search.cu::kMaxSteps
INF_BITS = 0x7F800000
BUCKETS = tref.RANK_TABLE_BUCKETS

_jax_digits = jax.jit(jsp._hist_digits)
_jax_count_ge = jax.jit(jsp.count_ge)


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


# ---------------------------------------------------------------------------
# the digit rule of hist_topq_level (one lane)
# ---------------------------------------------------------------------------

def _search_d1(m, tau1):
    """The kernel's binary search over tau1 (NaN magnitudes are placed
    before it is called)."""
    lo = torch.zeros_like(m, dtype=torch.int64)
    hi = torch.full_like(lo, tau1.numel())
    while bool((lo < hi).any()):
        mid = (lo + hi) // 2
        live = lo < hi
        ge = m >= tau1[mid.clamp(max=tau1.numel() - 1)]
        lo = torch.where(live & ge, mid + 1, lo)
        hi = torch.where(live & ~ge, mid, hi)
    return lo


def _search_d2(m, nl, w2e, nb):
    lo = torch.zeros_like(m, dtype=torch.int64)
    hi = torch.full_like(lo, nb)
    while bool((hi - lo > 1).any()):
        mid = (lo + hi) // 2
        live = hi - lo > 1
        ge = m >= tsp._fma(w2e, mid.to(torch.float32), nl)
        lo = torch.where(live & ge, mid, lo)
        hi = torch.where(live & ~ge, mid, hi)
    return lo


def _steps(m, est, below, above, k_max, lo, hi):
    """Step ``est`` by one toward the digit while ``below``/``above`` say
    it is off, at most k_max times. → (digit, settled)."""
    k = est.clone()
    for _ in range(k_max):
        b, a = below(k), above(k)
        k = torch.where(b, k - 1, torch.where(a, k + 1, k)).clamp(lo, hi)
    return k, ~(below(k) | above(k))


def mirror_digits(mag, tau1, new_lo, w2, top_shift):
    """→ (d1, d2, F contribution rows, stats) by the kernel's rule."""
    b = tau1.numel()
    nan = torch.isnan(mag)
    m = torch.where(nan, torch.zeros_like(mag), mag)
    lower = torch.cat([_f32([-math.inf]), tau1])
    upper = torch.cat([tau1, _f32([math.nan])])
    succ = torch.cat([tau1[1:], _f32([math.inf])])
    fast = bool((tau1 <= succ).all() & torch.isfinite(new_lo).all()
                & torch.isfinite(w2).all() & (w2 >= 0).all())
    stats = dict(fast=fast, off1=0, off2=0, searched=0)
    if not fast:
        d1 = _search_d1(m, tau1)
        d2 = _search_d2(m, new_lo[d1], w2[d1], b + 1)
    else:
        inv1 = (_f32(b - 1) / (tau1[-1] - tau1[0]) if b > 1 else _f32(0.0))
        inv2 = _f32(1.0) / w2[0]
        est1 = tsp._fma(m - tau1[0], inv1, _f32(1.0))
        est1 = est1.clamp(0, b).nan_to_num(0.0).to(torch.int64)
        below1 = lambda k: ~(m >= lower[k])            # noqa: E731
        above1 = lambda k: m >= upper[k]                # noqa: E731
        d1, ok1 = _steps(m, est1, below1, above1, K_STEPS, 0, b)
        d1 = torch.where(ok1, d1, _search_d1(m, tau1))
        nl, w2e = new_lo[d1], w2[d1]
        cand = lambda j: tsp._fma(w2e, j.to(torch.float32), nl)  # noqa
        est2 = ((m - nl) * inv2).clamp(0, b).nan_to_num(0.0).to(torch.int64)
        below2 = lambda c: (c > 0) & ~(m >= cand(c))   # noqa: E731
        above2 = lambda c: (c < b) & (m >= cand(c + 1))  # noqa: E731
        d2, ok2 = _steps(m, est2, below2, above2, K_STEPS, 0, b)
        d2 = torch.where(ok2, d2, _search_d2(m, nl, w2e, b + 1))
        stats.update(off1=(est1 - d1).abs()[~nan], off2=(est2 - d2).abs()[~nan],
                     searched1=~ok1 & ~nan, searched2=~ok2 & ~nan)
    d1 = torch.where(nan, torch.full_like(d1, b), d1)
    d2 = torch.where(nan, torch.zeros_like(d2), d2)
    return d1, d2, stats


def mirror_hist(mag, tables):
    """(D2 [b+1, b+1], F [b+1]) of one lane by the kernel's rule, F by its
    complement for r >= 1."""
    tau1, new_lo, w2, top_shift = tables
    nb = tau1.numel() + 1
    d1, d2, stats = mirror_digits(mag, *tables)
    D2 = torch.zeros(nb * nb, dtype=torch.int32).index_add_(
        0, d1 * nb + d2, torch.ones_like(d1, dtype=torch.int32))
    ge = mag >= top_shift[d1]
    counted = torch.where(d1 == 0, ge, ~ge).to(torch.int32)
    G = torch.zeros(nb, dtype=torch.int32).index_add_(0, d1, counted)
    rows = D2.reshape(nb, nb).sum(1, dtype=torch.int32)
    F = torch.where(torch.arange(nb) == 0, G, rows - G)
    return D2.reshape(nb, nb), F, stats


def _tables_of(op: torch.Tensor, branch: int):
    hi = torch.clamp(op.abs().amax(-1), min=1e-30) * tsp._HI_SCALE
    return tsp._hist_tables(torch.zeros_like(hi), hi, branch)


def _hist_case(kind: str, branch: int, seed: int):
    """[2, d] magnitudes and their tables (computed before the special
    values go in, so they stay finite)."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal((2, 6000)).astype(np.float32))
    if kind == "zero":
        g[1] = 0.0
    tables = _tables_of(g, branch)
    if kind == "edges":
        edge = tref.hist_edge_magnitudes(tables, 3000, seed=seed)
        up = torch.nextafter(edge, _f32(math.inf))
        g[:, :3000] = edge
        g[:, 3000:4500] = up[:, :1500]
    elif kind == "specials":
        g[0, :600] = tref.special_magnitudes(600, seed=seed)
    return g.abs(), tables


@pytest.mark.parametrize("branch", [1, 3, 64, 256, 1024])
@pytest.mark.parametrize("kind", ["edges", "zero", "specials"])
def test_digit_rule_matches_the_references(branch, kind):
    mag, tables = _hist_case(kind, branch, seed=branch)
    want = tsp._hist_digits(mag, *tables)
    for w in range(mag.shape[0]):
        lane = tuple(t[w] for t in tables)
        D2, F, stats = mirror_hist(mag[w], lane)
        jd2, jf = _jax_digits(*(jnp.asarray(t.numpy()) for t in
                                (mag[w],) + lane))
        for got, torch_ref, jax_ref in ((D2, want[0][w], jd2),
                                        (F, want[1][w], jf)):
            assert torch.equal(got, torch_ref)
            np.testing.assert_array_equal(got.numpy(), np.asarray(jax_ref))
        assert stats["fast"], "hist tables meet the rule's conditions"
        # an estimate more than K_STEPS off must have taken the search
        for off, searched in ((stats["off1"], stats["searched1"]),
                              (stats["off2"], stats["searched2"])):
            assert bool((searched[~torch.isnan(mag[w])] | (off <= K_STEPS))
                        .all())
        if branch <= 256 and kind != "zero":
            assert int(stats["searched1"].sum() + stats["searched2"].sum()) \
                == 0, "the estimate settles within K_STEPS on these tables"


def test_digit_rule_searches_on_tables_it_cannot_take():
    mag, tables = _hist_case("edges", 64, seed=9)
    tau1, new_lo, w2, top_shift = (t.clone() for t in tables)
    w2[0, 3] = -w2[0, 3]
    new_lo[1, 5] = math.nan
    odd = (tau1, new_lo, w2, top_shift)
    want = tsp._hist_digits(mag, *odd)
    for w in range(2):
        D2, F, stats = mirror_hist(mag[w], tuple(t[w] for t in odd))
        assert not stats["fast"]
        assert torch.equal(D2, want[0][w]) and torch.equal(F, want[1][w])


# ---------------------------------------------------------------------------
# the rank table of count_ge
# ---------------------------------------------------------------------------

def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64)


def mirror_rank_table(taus: torch.Tensor):
    keys = torch.where(torch.isnan(taus), _f32(math.inf), taus)
    s = torch.sort(keys).values
    n = s.numel()
    below = int((s <= 0).sum())
    finite = int((s < math.inf).sum())
    if below < finite:
        lo, hi = int(_bits(s[below])), int(_bits(s[finite - 1]))
    else:
        lo = hi = INF_BITS
    shift = 0
    while (hi - lo) >> shift >= BUCKETS:
        shift += 1
    bucket = (_bits(s[below:finite]) - lo) >> shift
    P = below + torch.searchsorted(bucket, torch.arange(BUCKETS + 1))
    assert tref.rank_table_range(taus) == (
        None if below == finite else (lo, hi, shift))
    return dict(s=s, n=n, below=below, finite=finite, lo=lo, hi=hi,
                shift=shift, P=P, inside=P[1:] > P[:-1])


def mirror_rank(m: torch.Tensor, t: dict) -> torch.Tensor:
    """#{sorted keys <= m} by the table; m = |x| in float32."""
    u = _bits(m)
    r = torch.where(u > INF_BITS, 0,
                    torch.where(u == INF_BITS, t["n"], t["finite"]))
    r = torch.where(u < t["lo"], t["below"], r)
    inr = (u >= t["lo"]) & (u < t["hi"])
    k = ((u - t["lo"]) >> t["shift"]).clamp(0, BUCKETS - 1)
    lo, hi = t["P"][k], t["P"][k + 1]
    searched = inr & t["inside"][k]
    lo = torch.where(searched, lo, hi)
    s = t["s"]
    while bool((lo < hi).any()):
        mid = (lo + hi) // 2
        live = lo < hi
        ge = m >= s[mid.clamp(max=t["n"] - 1)]
        lo = torch.where(live & ge, mid + 1, lo)
        hi = torch.where(live & ~ge, mid, hi)
    r = torch.where(inr, torch.where(searched, lo, t["P"][k]), r)
    return r, searched


def mirror_count_ge(x: torch.Tensor, taus: torch.Tensor):
    t = mirror_rank_table(taus)
    ranks, searched = mirror_rank(x.to(torch.float32).abs(), t)
    hist = torch.bincount(ranks, minlength=t["n"] + 1)
    suffix = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0])
    keys = torch.where(torch.isnan(taus), _f32(math.inf), taus)
    place = torch.empty(t["n"], dtype=torch.int64)
    place[torch.sort(keys, stable=True).indices] = torch.arange(t["n"])
    counts = suffix[place + 1].to(torch.int32)
    return torch.where(torch.isnan(taus), 0, counts), searched


@pytest.mark.parametrize("n_taus", [1, 64, 4095])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rank_table_rule_matches_the_references(n_taus, dtype):
    taus = tref.count_edge_taus(n_taus, seed=n_taus)
    x = tref.count_edge_magnitudes(taus, 9000, seed=n_taus)
    x[:300] = tref.special_magnitudes(300, seed=n_taus)
    jx = jnp.asarray(x.numpy()).astype(dtype)
    row = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    got, searched = mirror_count_ge(row, taus)
    assert torch.equal(got, tref.ref_count_ge(row, taus))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(_jax_count_ge(jnp.abs(jx.astype(jnp.float32)),
                                              jnp.asarray(taus.numpy()))))
    # one table load answers every element outside the taus' buckets
    t = mirror_rank_table(taus)
    assert int(t["inside"].sum()) <= t["finite"] - t["below"]
    assert int(searched.sum()) < row.numel()


def test_rank_table_answers_random_rows_with_one_load():
    """On a search round's evenly spaced taus, few elements land in a
    bucket that holds a tau."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        200_000).astype(np.float32))
    hi = x.abs().max() * tsp._HI_SCALE
    taus = tsp._fma(hi / 64, torch.arange(1, 65, dtype=torch.float32),
                    _f32(0.0))
    got, searched = mirror_count_ge(x, taus)
    assert torch.equal(got, tref.ref_count_ge(x, taus))
    assert float(searched.float().mean()) < 0.05
