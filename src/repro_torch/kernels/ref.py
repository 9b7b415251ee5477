"""Plain PyTorch versions of the kernels (the port of
:mod:`repro.kernels.ref`).

Each ``ref_*`` function is the contract its CUDA kernel meets bit for bit:
the level kernels of :mod:`repro_torch.kernels.level` and the scalar
``[d]`` kernels of :mod:`.chain_accum`, :mod:`.sparsify_ef` and
:mod:`.topq_threshold`. They are what the
kernel wrappers run for CPU tensors, and what the tests hold against the
JAX package.

Rounding follows the jitted JAX reference exactly. XLA contracts every
``a*b + c`` of these bodies into one fused multiply-add, so each such site
is written as :func:`torch.addcmul` (one rounding), never as eager
``a*b + c`` (two roundings). The sites are ``w·g + e``, ``p·g̃ + γ_in``
and ``m·s + Λ``; the pinned ‖e′‖² fold contracts its first level too.
CL-SIA's scalar ``w·g + e + γ_in`` rounds as ``fl(fma(w, g, e) + γ_in)``.
The scalar versions compute in f32 and cast their outputs to the input
dtype (round to nearest even); ``nnz`` counts the f32 values before that
cast.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import sparsify as sp

Tensor = torch.Tensor

SUBLANES = 8
LANES = 1024
BLOCK = SUBLANES * LANES


def lanes_per_cohort(gmask: Tensor, lanes: int, gmask_cohorts: int) -> int:
    """→ lanes per cohort of a cohort-shared ``[B, d]`` mask
    (``gmask_cohorts=B``) over ``lanes`` cohort-major lanes: lane w reads
    row w // (lanes / B). ``ValueError`` (the reference's) unless the mask
    has B rows and B divides the lanes."""
    if gmask.shape[0] != gmask_cohorts or lanes % gmask_cohorts:
        raise ValueError(
            f"cohort gmask {tuple(gmask.shape)} incompatible with "
            f"{lanes} lanes / {gmask_cohorts} cohorts")
    return lanes // gmask_cohorts


def expand_gmask(gmask: Optional[Tensor], lanes: int, gmask_cohorts: int):
    """A cohort-shared ``[B, d]`` gmask (``gmask_cohorts=B``) → per-lane
    ``[lanes, d]``, cohort-major (any trailing shape: ``[B, 1]`` per-cohort
    counts repeat alike). Values are only repeated, so each lane computes
    what the sequential call with its cohort's ``[d]`` mask computes. Other
    masks (none, lane-shared ``[d]``, per-lane without ``gmask_cohorts``)
    pass through."""
    if gmask is None or not gmask_cohorts or gmask.dim() != 2:
        return gmask
    return gmask.repeat_interleave(
        lanes_per_cohort(gmask, lanes, gmask_cohorts), dim=0)


def _apply_valid(valid: Tensor, *arrays):
    """Zero the rows of lanes with ``valid == 0`` (schedule padding)."""
    v = (valid > 0)[:, None]
    out = tuple(torch.where(v, a, torch.zeros_like(a)) for a in arrays)
    return out if len(out) > 1 else out[0]


def ref_err_sq_level(e_new: Tensor) -> Tensor:
    """Pinned-order ‖e′‖² per lane — the ``err_sq_mode="kernel"`` contract.

    Each zero-padded (SUBLANES, LANES) f32 tile is squared and folded
    pairwise over lanes (1024 → 512 → … → 1: ``x[:, :n] + x[:, n:2n]``),
    then over sublanes (8 → 4 → 2 → 1); tile scalars accumulate left to
    right. The first lane fold is one fused multiply-add per pair,
    ``fma(a, a, b·b)`` with ``a`` from the lower half, as XLA contracts
    the square into that add.
    """
    w_lanes, d = e_new.shape
    n_blocks = max(1, -(-d // BLOCK))
    pad = n_blocks * BLOCK - d
    tiles = torch.nn.functional.pad(e_new.to(torch.float32), (0, pad))
    tiles = tiles.reshape(w_lanes, n_blocks, SUBLANES, LANES)
    half = LANES // 2
    lo, hi = tiles[..., :half], tiles[..., half:]
    sq = torch.addcmul(hi * hi, lo, lo)
    n = half
    while n > 1:
        n //= 2
        sq = sq[..., :n] + sq[..., n:2 * n]
    m = SUBLANES
    while m > 1:
        m //= 2
        sq = sq[..., :m, :] + sq[..., m:2 * m, :]
    per_block = sq[..., 0, 0]                        # [W, n_blocks]
    acc = per_block[:, 0]
    for j in range(1, n_blocks):
        acc = acc + per_block[:, j]
    return acc


def ref_sparsify_ef_level(g, e, mask_in, weight, tau, valid, *,
                          with_err: bool = False):
    """Fused error feedback + sparsify over a level's W lanes: see
    :func:`_sparsify_ef_level`."""
    return _sparsify_ef_level(g, e, mask_in, weight, tau, valid,
                              with_err=with_err)


def _sparsify_ef_level(g, e, mask_in, weight, tau, valid, *,
                       with_err: bool = False):
    """Fused error feedback + sparsify over a level's W lanes.

    g̃ = w·g + e; keep = |g̃| ≥ τ ∨ mask_in; ḡ = keep ? g̃ : 0;
    e′ = g̃ − ḡ. Lanes with ``valid == 0`` output zeros. ``mask_in`` may be
    None (pure-threshold keep). Returns (ḡ, e′, nnz [W] i32), plus the
    pinned-order ‖e′‖² [W] f32 when ``with_err``.
    """
    gt = torch.addcmul(e.to(torch.float32), weight[:, None].to(torch.float32),
                       g.to(torch.float32))
    keep = gt.abs() >= tau[:, None].to(torch.float32)
    if mask_in is not None:
        keep = keep | (mask_in > 0)
    gbar = torch.where(keep, gt, torch.zeros_like(gt))
    e_new = gt - gbar
    gbar, e_new = _apply_valid(valid, gbar, e_new)
    nnz = (gbar != 0).sum(dim=-1, dtype=torch.int32)
    out = (gbar.to(g.dtype), e_new.to(e.dtype), nnz)
    return out + (ref_err_sq_level(e_new),) if with_err else out


def _off_mask_count(nz: Tensor, gmask: Optional[Tensor], nnz: Tensor):
    if gmask is None:
        return nnz
    return (nz & (gmask <= 0)).sum(dim=-1, dtype=torch.int32)


def ref_chain_accum_level(gamma_in, gbar, valid, gmask=None, *,
                          gmask_cohorts: int = 0):
    """γ_out = γ_in + ḡ with the total and off-global-mask support counts:
    see :func:`_chain_accum_level`."""
    return _chain_accum_level(gamma_in, gbar, valid, gmask,
                              gmask_cohorts=gmask_cohorts)


def _chain_accum_level(gamma_in, gbar, valid, gmask=None, *,
                       gmask_cohorts: int = 0):
    """γ_out = γ_in + ḡ with the total and off-global-mask support counts.

    ``gmask`` is lane-shared ``[d]``, per-lane ``[W, d]`` or, with
    ``gmask_cohorts=B``, cohort-shared ``[B, d]``; without it
    ``nnz_off == nnz``. Returns (γ_out, nnz [W] i32, nnz_off [W] i32).
    """
    gmask = expand_gmask(gmask, gamma_in.shape[0], gmask_cohorts)
    gamma = gamma_in.to(torch.float32) + gbar.to(torch.float32)
    gamma = _apply_valid(valid, gamma)
    nz = gamma != 0
    nnz = nz.sum(dim=-1, dtype=torch.int32)
    return (gamma.to(gamma_in.dtype), nnz,
            _off_mask_count(nz, gmask, nnz))


def ref_cl_fuse_level(g, e, gamma_in, weight, tau, participate, valid,
                      gmask=None, mask_in=None, *, gmask_cohorts: int = 0,
                      with_err: bool = False):
    """The complete CL node step (Algorithms 3/5 with stragglers): see
    :func:`_cl_fuse_level`."""
    return _cl_fuse_level(g, e, gamma_in, weight, tau, participate, valid,
                          gmask, mask_in, gmask_cohorts=gmask_cohorts,
                          with_err=with_err)


def _cl_fuse_level(g, e, gamma_in, weight, tau, participate, valid,
                   gmask=None, mask_in=None, *, gmask_cohorts: int = 0,
                   with_err: bool = False):
    """The complete CL node step (Algorithms 3/5 with stragglers).

    g̃ = w·g + e; s = p·g̃ + γ_in; Λ̃ = (1−m)·s; keep = |Λ̃| ≥ τ ∨ mask_in;
    Λ = keep ? Λ̃ : 0; e′ = Λ̃ − Λ; γ = m·s + Λ (Alg 3: γ = Λ); a lane with
    p = 0 forwards (γ_in, g̃). Returns (γ_out, e′, nnz [W] i32,
    nnz_off [W] i32), plus the pinned-order ‖e′‖² when ``with_err``.
    ``gmask`` takes the forms of :func:`ref_chain_accum_level`.
    """
    gmask = expand_gmask(gmask, g.shape[0], gmask_cohorts)
    w = weight[:, None].to(torch.float32)
    p = participate[:, None].to(torch.float32)
    gt = torch.addcmul(e.to(torch.float32), w, g.to(torch.float32))
    gin = gamma_in.to(torch.float32)
    s = torch.addcmul(gin, p, gt)
    lam_t = (1.0 - gmask) * s if gmask is not None else s
    keep = lam_t.abs() >= tau[:, None].to(torch.float32)
    if mask_in is not None:
        keep = keep | (mask_in > 0)
    lam = torch.where(keep, lam_t, torch.zeros_like(lam_t))
    e_new = lam_t - lam
    gamma = torch.addcmul(lam, gmask, s) if gmask is not None else lam
    alive = p > 0
    gamma = torch.where(alive, gamma, gin)
    e_new = torch.where(alive, e_new, gt)
    gamma, e_new = _apply_valid(valid, gamma, e_new)
    nz = gamma != 0
    nnz = nz.sum(dim=-1, dtype=torch.int32)
    out = (gamma.to(gamma_in.dtype), e_new.to(e.dtype), nnz,
           _off_mask_count(nz, gmask, nnz))
    return out + (ref_err_sq_level(e_new),) if with_err else out


def fused_operand(g, e, gamma_in, weight, participate, gmask=None, *,
                  include_gamma: bool = False, gmask_cohorts: int = 0):
    """The sparsifier operand rebuilt from raw node inputs (f32 [W, d]).

    * SIA / RE-SIA:  ``w·g + e``
    * CL-SIA:        ``p·(w·g + e) + γ_in``      (include_gamma)
    * TC-SIA:        ``(1−m)·(w·g + e)``          (gmask given)
    * CL-TC-SIA:     ``(1−m)·(p·(w·g + e) + γ_in)``

    The same float expressions as the kernels, so the exact Top-Q masks
    computed from it select what the kernels' τ test would. ``gmask`` takes
    the forms of :func:`ref_chain_accum_level`.
    """
    gmask = expand_gmask(gmask, g.shape[0], gmask_cohorts)
    s = torch.addcmul(e.to(torch.float32), weight[:, None].to(torch.float32),
                      g.to(torch.float32))
    if include_gamma:
        s = torch.addcmul(gamma_in.to(torch.float32),
                          participate[:, None].to(torch.float32), s)
    if gmask is not None:
        s = (1.0 - gmask) * s
    return s


def ref_cl_fuse_select_level(g, e, gamma_in, weight, participate, valid,
                             gmask=None, *, q: int, gmask_cohorts: int = 0,
                             with_err: bool = False):
    """The exact CL node step of a level: the Top-Q support of the CL
    operand (:func:`fused_operand` with γ_in, the stable descending sort's
    choice, :func:`repro_torch.core.sparsify.topq_mask`), then
    :func:`ref_cl_fuse_level` with that support as ``mask_in`` and τ =
    +inf. → (γ_out, e′, nnz [W] i32, nnz_off [W] i32), plus the pinned
    ‖e′‖² with ``with_err``. The chain the resident kernel replaces, bit
    for bit; ``gmask`` takes the forms of :func:`ref_chain_accum_level`.
    """
    op = fused_operand(g, e, gamma_in, weight, participate, gmask,
                       include_gamma=True, gmask_cohorts=gmask_cohorts)
    mask = sp.topq_mask(op, q)
    tau = torch.full((g.shape[0],), math.inf, dtype=torch.float32,
                     device=g.device)
    return _cl_fuse_level(g, e, gamma_in, weight, tau, participate, valid,
                          gmask, mask, gmask_cohorts=gmask_cohorts,
                          with_err=with_err)


#: The node-step kinds of :func:`ref_ia_fuse_select_level`, in the order of
#: their codes in the kernel's C interface.
IA_KINDS = ("sia", "re_sia", "tc_sia")


def ia_kind(kind, gmask, q, tau) -> str:
    """The kind of an ``ia_fuse_select_level`` call as its name (an
    ``AggKind`` or its value), after the checks the kernel and its plain
    version share: a kind of :data:`IA_KINDS`, a global mask for TC-SIA
    alone, and exactly one of ``q`` (exact Top-Q) and ``tau`` (a given
    τ). ``ValueError`` otherwise."""
    kind = getattr(kind, "value", kind)
    if kind not in IA_KINDS:
        raise ValueError(f"ia_fuse_select_level takes the kinds {IA_KINDS}, "
                         f"got {kind!r}")
    if gmask is not None and kind != "tc_sia":
        raise ValueError(f"{kind} reads no global mask")
    if (q is None) == (tau is None):
        raise ValueError("give q (exact Top-Q) or tau (a given τ), one of "
                         "them")
    return kind


def ref_ia_fuse_select_level(g, e, gamma_in, weight, participate, valid,
                             gmask=None, *, kind, q=None, tau=None,
                             gmask_cohorts: int = 0, with_err: bool = False):
    """The SIA, RE-SIA or TC-SIA node step of a level: the chain the
    resident kernel replaces, bit for bit — the keep mask of
    ``core/algorithms.py``, then :func:`ref_sparsify_ef_level`, then
    :func:`ref_chain_accum_level` (their bodies, so a count of the plain
    versions' calls sees one call).

    The local support m_k is the Top-Q support of the operand
    (:func:`fused_operand` without γ: ``w·g + e``, TC-SIA ``(1−m)·(w·g +
    e)``; :func:`repro_torch.core.sparsify.topq_mask`) for ``q``, or
    ``|x| ≥ τ`` for a given ``tau`` [W]. The mask and τ′ of the keep test
    ``|g̃| ≥ τ′ ∨ mask > 0``:

    * SIA: ``m_k · p`` and τ′ = +inf; given τ, no mask and τ′ = τ where
      p > 0, else +inf;
    * RE-SIA: ``1(m_k + supp(γ_in)) · p`` and τ′ = +inf; given τ,
      ``supp(γ_in) · p`` and τ′ as SIA's;
    * TC-SIA: ``1(m + m_k + clamp(supp(γ_in) − m, 0, 1)) · p``, τ′ = +inf.

    ``gmask`` (TC-SIA only) takes the forms of
    :func:`ref_chain_accum_level`. → (γ_out, e′, nnz [W] i32, nnz_off [W]
    i32), plus the pinned ‖e′‖² with ``with_err``.
    """
    kind = ia_kind(kind, gmask, q, tau)
    w_lanes = g.shape[0]
    p = participate[:, None].to(torch.float32)
    inf = torch.full((w_lanes,), math.inf, dtype=torch.float32,
                     device=g.device)
    x = fused_operand(g, e, None, weight, participate, gmask,
                      gmask_cohorts=gmask_cohorts)
    if tau is None:
        m_k = sp.topq_mask(x, q)
    elif kind == "tc_sia":
        m_k = (x.abs() >= tau[:, None].to(torch.float32)).to(x.dtype)
    else:
        m_k = None
    tau_keep = inf
    if m_k is None:
        tau_keep = torch.where(participate > 0, tau.to(torch.float32), inf)
    support = sp.support(gamma_in.to(torch.float32))
    if kind == "sia":
        mask = None if m_k is None else m_k * p
    elif kind == "re_sia":
        mask = (support if m_k is None else sp.mask_union(m_k, support)) * p
    else:
        gme = expand_gmask(gmask, w_lanes, gmask_cohorts)
        gme = torch.zeros_like(x) if gme is None else gme
        m_in = torch.clamp(support - gme, 0, 1)
        mask = sp.mask_union(torch.broadcast_to(gme, m_k.shape), m_k,
                             m_in) * p
    out = _sparsify_ef_level(g, e, mask, weight, tau_keep, valid,
                             with_err=with_err)
    gout, nnz, nnz_off = _chain_accum_level(gamma_in, out[0], valid, gmask,
                                            gmask_cohorts=gmask_cohorts)
    return (gout, out[1], nnz, nnz_off) + out[3:]


# ---------------------------------------------------------------------------
# τ search: candidate counts and the joint digit histogram
# ---------------------------------------------------------------------------

def _count_ge_rows(mag: Tensor, taus: Tensor) -> Tensor:
    """``counts[w, b] = #{i : mag[w, i] >= taus[w, b]}`` for taus in any
    order, by one sort and binary searches (exact float comparisons).
    NaN magnitudes count for no τ and a NaN τ counts nothing, as in the
    broadcast comparison of the reference."""
    d = mag.shape[-1]
    nan = torch.isnan(mag)
    smag = torch.sort(torch.where(nan, torch.full_like(mag, math.inf), mag),
                      dim=-1).values
    below = torch.searchsorted(smag, taus.contiguous(), side="left")
    counts = d - nan.sum(dim=-1, keepdim=True) - below
    return torch.where(torch.isnan(taus), torch.zeros_like(counts),
                       counts).to(torch.int32)


def ref_count_ge_level(x: Tensor, taus: Tensor) -> Tensor:
    """counts[w, b] = #{i : |x_{w,i}| >= taus_{w,b}}; x [W, d], taus [W, B]
    in any order → int32 [W, B]."""
    return _count_ge_rows(x.to(torch.float32).abs(),
                          taus.to(torch.float32))


def ref_count_ge_fused_level(g, e, gamma_in, weight, participate, taus,
                             gmask=None, *, include_gamma: bool = False,
                             gmask_cohorts: int = 0) -> Tensor:
    """Candidate counts of the fused operand (see :func:`fused_operand`):
    [W, d] inputs, taus [W, B] → int32 [W, B]. Counts run over the d real
    elements only."""
    op = fused_operand(g, e, gamma_in, weight, participate, gmask,
                       include_gamma=include_gamma,
                       gmask_cohorts=gmask_cohorts)
    return _count_ge_rows(op.abs(), taus.to(torch.float32))


def ref_tau_search_fused_level(g, e, gamma_in, weight, participate,
                               gmask=None, *, q: int, branch: int,
                               rounds: int, include_gamma: bool = False,
                               gmask_cohorts: int = 0):
    """The whole threshold τ search of a level: ``threshold_for_topq``
    (scan) over :func:`fused_operand`, counting with the plain counts of
    :func:`ref_count_ge_fused_level`. → ``(τ [W] f32, counts [rounds, W,
    branch] i32)``, what the search over the count kernel returns.
    """
    op = fused_operand(g, e, gamma_in, weight, participate, gmask,
                       include_gamma=include_gamma,
                       gmask_cohorts=gmask_cohorts)
    return sp.threshold_for_topq(op, q, branch=branch, rounds=rounds,
                                 count_fn=_count_ge_rows, with_counts=True)


def ref_hist_topq_level(g, e, gamma_in, weight, participate, tables,
                        gmask=None, *, include_gamma: bool = False,
                        gmask_cohorts: int = 0):
    """Joint digit histogram of the fused operand (``tau_impl="hist"``).

    ``tables = (tau1 [W, b], new_lo, w2, top_shift [W, b+1])`` from
    :func:`repro_torch.core.sparsify._hist_tables`; → ``(D2 [W, b+1, b+1],
    F [W, b+1])`` int32 over the d real elements (no padding in
    ``D2[w, 0, 0]``). See :func:`repro_torch.core.sparsify._hist_digits`.
    """
    op = fused_operand(g, e, gamma_in, weight, participate, gmask,
                       include_gamma=include_gamma,
                       gmask_cohorts=gmask_cohorts)
    return sp._hist_digits(op.abs(),
                           *(t.to(torch.float32) for t in tables))


def hist_edge_magnitudes(tables, per_lane: int, seed: int = 0) -> Tensor:
    """[W, per_lane] magnitudes placed on the bin edges of ``tables``.

    Each lane draws from: its round-2 candidates ``fma(w2, j, new_lo)``
    where a separate multiply and add would round otherwise, its round-1
    candidates ``tau1`` and its bracket tops ``top_shift[1:]``, each value
    and the float just below it. A histogram whose candidates or edge
    comparisons round differently from the reference's bins some of these
    elements elsewhere; random data almost never shows that.
    """
    tau1, new_lo, w2, top_shift = (t.detach().to("cpu", torch.float32)
                                   for t in tables)
    j = torch.arange(1, tau1.shape[-1] + 1, dtype=torch.float32)
    fused = torch.addcmul(new_lo[..., None], w2[..., None], j)
    split = new_lo[..., None] + w2[..., None] * j
    rng = np.random.default_rng(seed)
    rows = []
    for w in range(tau1.shape[0]):
        pool = torch.cat([fused[w][fused[w] != split[w]], tau1[w],
                          top_shift[w, 1:]])
        pool = torch.cat([pool, torch.nextafter(pool, torch.zeros(()))])
        rows.append(pool[torch.from_numpy(
            rng.integers(0, pool.numel(), per_lane))])
    return torch.stack(rows)


#: Buckets of ``count_ge``'s rank table (``csrc/topq_threshold.cu``,
#: ``kBuckets``): the bit patterns from the smallest positive finite τ to
#: the largest are cut into this many buckets of 2**shift patterns each.
RANK_TABLE_BUCKETS = 4096


def rank_table_range(taus: Tensor) -> tuple:
    """→ (lo_bits, hi_bits, shift) of ``count_ge``'s rank table over
    ``taus`` (NaN sorts as +inf), or None without a positive finite τ."""
    t = taus.detach().to("cpu", torch.float32)
    pos = t[(t > 0) & torch.isfinite(t)]
    if not pos.numel():
        return None
    lo = int(pos.min().view(torch.int32))
    hi = int(pos.max().view(torch.int32))
    shift = 0
    while (hi - lo) >> shift >= RANK_TABLE_BUCKETS:
        shift += 1
    return lo, hi, shift


def count_edge_magnitudes(taus: Tensor, n: int, seed: int = 0) -> Tensor:
    """[n] float32 values on the edges of ``count_ge``'s rank table.

    Half the values are drawn from each τ and the floats one ulp either
    side, 0, +inf and NaN; the other half from the first bit pattern of
    every bucket of the table over ``taus``, the pattern just below it and
    the range's ends. Signs are random. A rank that an off-by-one bucket or
    a wrong comparison gets wrong shows on these; random data hits few.
    """
    t = taus.detach().to("cpu", torch.float32)
    finite = t[torch.isfinite(t)]
    near = torch.cat([finite, torch.nextafter(finite, torch.tensor(-math.inf)),
                      torch.nextafter(finite, torch.tensor(math.inf)),
                      torch.tensor([0.0, math.inf, math.nan])]).abs()
    edges = near
    table = rank_table_range(t)
    if table is not None:
        lo, hi, shift = table
        starts = lo + (np.arange(RANK_TABLE_BUCKETS, dtype=np.int64) << shift)
        starts = np.concatenate([starts[starts <= hi], [hi, hi + 1]])
        bits = np.concatenate([starts, starts - 1]).astype(np.int32)
        edges = torch.from_numpy(bits).view(torch.float32)
    rng = np.random.default_rng(seed)
    x = torch.where(torch.from_numpy(rng.random(n) < 0.5),
                    near[torch.from_numpy(rng.integers(0, near.numel(), n))],
                    edges[torch.from_numpy(rng.integers(0, edges.numel(),
                                                        n))])
    return torch.where(torch.from_numpy(rng.random(n) < 0.5), -x, x)


def count_edge_taus(n: int, seed: int = 0) -> Tensor:
    """[n] float32 taus in any order: |normal|·1.5 draws and, where n
    allows, τ = −1, 0, +inf, NaN, a tie and taus placed on bucket
    boundaries of ``count_ge``'s rank table over the others."""
    rng = np.random.default_rng(seed)
    taus = np.abs(rng.standard_normal(n)).astype(np.float32) * 1.5
    if n >= 8:
        taus[:5] = [-1.0, 0.0, np.inf, np.nan, taus[7]]
        lo, hi, shift = rank_table_range(torch.from_numpy(taus[5:]))
        k = rng.integers(0, ((hi - lo) >> shift) + 1, max(1, n // 8))
        on = (lo + (k.astype(np.int64) << shift)).astype(np.int32)
        taus[5:5 + on.size] = on.view(np.float32)
    return torch.from_numpy(rng.permutation(taus))


def special_magnitudes(n: int, seed: int = 0) -> Tensor:
    """[n] float32 values: NaN, ±inf, ±0, subnormals, the smallest
    normals and a few ordinary values, in a random order."""
    vals = torch.tensor([math.nan, math.inf, -math.inf, 0.0, -0.0, 1e-45,
                         -1e-45, 3e-39, 1.1754944e-38, -1.1754944e-38, 0.5,
                         -2.0, 1e30], dtype=torch.float32)
    rng = np.random.default_rng(seed)
    return vals[torch.from_numpy(rng.integers(0, vals.numel(), n))]


def resident_edge_lanes(w: int, d: int, seed: int = 0, q: int = 11) -> dict:
    """Float32 inputs of a ``[W, d]`` level (CPU tensors ``g, e, gin, w, p,
    valid``) for the resident kernels; with W ≥ 7 the first lanes are the
    edge rows: 0 ties straddling the q-th magnitude, 1 p = 0, 2 a few NaN
    and ±inf, 3 all zeros (γ_in −0.0), 4 valid = 0, 5 more ±inf and NaN
    than q, 6 fewer nonzeros than q (ties at zero straddling the q-th
    place, −0.0 among them)."""
    rng = np.random.default_rng(seed)
    f = lambda: rng.standard_normal((w, d)).astype(np.float32)  # noqa
    x = dict(g=f(), e=(0.3 * f()).astype(np.float32),
             gin=(f() * (rng.random((w, d)) < 0.3)).astype(np.float32),
             w=rng.uniform(0.2, 2.0, w).astype(np.float32),
             p=np.ones(w, np.float32), valid=np.ones(w, np.float32))
    if w >= 7:
        for lane in (0, 2, 3, 5, 6):
            x["e"][lane] = 0.0
            x["gin"][lane] = 0.0
            x["w"][lane] = 1.0
        x["g"][0] = rng.choice(np.float32([-2, -1, -0.5, 0.5, 1, 2]), d)
        x["p"][1] = 0.0
        pos = rng.choice(d, 6, replace=False)
        x["g"][2, pos] = [np.nan, np.inf, -np.inf, np.nan, np.inf, -np.inf]
        x["g"][3] = 0.0
        x["gin"][3] = -0.0
        x["valid"][4] = 0.0
        pos = rng.choice(d, q + 5, replace=False)
        x["g"][5, pos[:q + 2]] = np.where(rng.random(q + 2) < 0.5,
                                          np.inf, -np.inf)
        x["g"][5, pos[q + 2:]] = np.nan
        x["g"][6] = 0.0
        x["g"][6, :q // 2] = -3.0
        x["g"][6, q // 2:q // 2 + 3] = -0.0
    return {k: torch.from_numpy(v) for k, v in x.items()}


def resident_gmask(form: Optional[str], w: int, d: int, seed: int = 0,
                   cohorts: int = 0) -> Optional[Tensor]:
    """A 0/1 float32 global mask of a resident test level: None,
    ``"shared"`` [d], ``"lanes"`` [W, d] or ``"cohort"`` [cohorts, d]; or
    ``"odd"``, a [W, d] mask that also holds values other than 0 and 1
    (0.5, −0.25, 2, −0.0, NaN)."""
    if form is None:
        return None
    rng = np.random.default_rng(seed + 100)
    if form == "odd":
        vals = np.float32([0, 0, 0, 1, 0.5, -0.25, 2, np.nan, -0.0])
        return torch.from_numpy(vals[rng.integers(0, vals.size, (w, d))])
    shape = {"shared": (d,), "lanes": (w, d), "cohort": (cohorts, d)}[form]
    return torch.from_numpy((rng.random(shape) < 0.1).astype(np.float32))


def resident_taus(x: dict, gmask: Optional[Tensor] = None,
                  cohorts: int = 0, q: int = 11) -> Tensor:
    """[W] float32 given τ for the lanes ``x`` of
    :func:`resident_edge_lanes`: each lane's q-th largest magnitude of its
    SIA-family operand (:func:`fused_operand` without γ; NaN magnitudes
    last), then, where W allows, a NaN τ on lane 2 (the lane of NaN and
    ±inf with W ≥ 7), τ = 0 on lane 7 and +inf on lane 8."""
    op = fused_operand(x["g"], x["e"], None, x["w"], x["p"], gmask,
                       gmask_cohorts=cohorts).abs()
    op = torch.where(torch.isnan(op), -1.0, op)
    srt = torch.sort(op, dim=-1, descending=True).values
    tau = srt[:, min(max(q, 1), op.shape[-1]) - 1].clone()
    w = tau.shape[0]
    if w >= 3:
        tau[2] = math.nan
    if w >= 9:
        tau[7], tau[8] = 0.0, math.inf
    return tau


def count_level_edge_taus(n: int, seed: int = 0) -> Tensor:
    """[5, n] float32 taus in any order whose lanes span other ranges:
    every τ ≤ 0 (0, −0 and −inf where n allows); |normal|·1.5 draws with
    +inf, −inf, NaN, 0 and ties; one value n times; log-uniform from the
    smallest subnormal to 1e30; a first scan round's n evenly spaced
    candidates below a maximum of 3 (what ``threshold_for_topq(count_fn=
    ...)`` counts). Each lane's rank table covers another range."""
    rng = np.random.default_rng(seed)
    t = np.abs(rng.standard_normal((5, n))).astype(np.float32) * 1.5
    t[0] = -t[0]
    t[0, :3] = [0.0, -0.0, -np.inf][:n]
    if n >= 8:
        t[1, :7] = [np.inf, -np.inf, np.nan, 0.0, np.inf, t[1, 7], t[1, 7]]
    t[2] = np.float32(0.7)
    t[3] = np.exp(rng.uniform(np.log(1e-45), np.log(1e30), n))
    hi = torch.full((1,), 3.0) * sp._HI_SCALE
    t[4] = sp._hist_tables(torch.zeros_like(hi), hi, n)[0][0].numpy()
    return torch.from_numpy(np.stack([rng.permutation(lane) for lane in t]))


def count_level_edge_rows(taus: Tensor, d: int, seed: int = 0) -> Tensor:
    """[W, d] float32 rows for ``count_ge_level`` over the lanes of
    ``taus``: each lane on the edges of its own rank table and its taus
    (:func:`count_edge_magnitudes`), with NaN, ±inf, ±0 and subnormals in
    the first tenth of lane 0."""
    x = torch.stack([count_edge_magnitudes(lane, d, seed=seed + w)
                     for w, lane in enumerate(taus)])
    x[0, :d // 10] = special_magnitudes(d // 10, seed=seed)
    return x


# ---------------------------------------------------------------------------
# scalar [d] kernels (repro.kernels.chain_accum / sparsify_ef /
# topq_threshold): one row, scalars as Python numbers or one-element tensors
# ---------------------------------------------------------------------------

def _f32(v, like: Tensor) -> Tensor:
    """A Python number or a one-element tensor as a 0-d f32 tensor on
    ``like``'s device."""
    return torch.as_tensor(v, dtype=torch.float32,
                           device=like.device).reshape(())


def _nnz(x: Tensor) -> Tensor:
    return (x != 0).sum(dtype=torch.int32)


def ref_count_ge(x: Tensor, taus: Tensor) -> Tensor:
    """counts[j] = #{i : |x_i| >= taus_j}; x [d] float, taus [B] f32 in any
    order → int32 [B]."""
    return _count_ge_rows(x.to(torch.float32).abs()[None],
                          taus.to(torch.float32)[None])[0]


def ref_sparsify_ef(g, e, mask_in, weight, tau):
    """Fused error feedback + threshold/mask sparsification of one row.

    g̃ = w·g + e; keep = |g̃| ≥ τ ∨ mask_in > 0 (``mask_in=None``: the
    threshold alone); ḡ = keep ? g̃ : 0; e′ = g̃ − ḡ. → (ḡ in g's dtype, e′
    in e's, nnz 0-d int32).
    """
    gt = torch.addcmul(e.to(torch.float32), _f32(weight, g),
                       g.to(torch.float32))
    keep = gt.abs() >= _f32(tau, g)
    if mask_in is not None:
        keep = keep | (mask_in > 0)
    gbar = torch.where(keep, gt, torch.zeros_like(gt))
    e_new = gt - gbar
    return gbar.to(g.dtype), e_new.to(e.dtype), _nnz(gbar)


def ref_chain_accum(gamma_in, gbar):
    """γ_out = γ_in + ḡ → (γ_out in γ_in's dtype, nnz 0-d int32)."""
    gamma = gamma_in.to(torch.float32) + gbar.to(torch.float32)
    return gamma.to(gamma_in.dtype), _nnz(gamma)


def ref_cl_fuse(g, e, gamma_in, weight, tau):
    """The CL-SIA node step of one row given τ (Algorithm 3, lines 2–5).

    γ̃ = fl(fma(w, g, e) + γ_in); γ_out = |γ̃| ≥ τ ? γ̃ : 0; e′ = γ̃ − γ_out.
    → (γ_out in γ_in's dtype, e′ in e's, nnz 0-d int32).
    """
    gt = torch.addcmul(e.to(torch.float32), _f32(weight, g),
                       g.to(torch.float32)) + gamma_in.to(torch.float32)
    keep = gt.abs() >= _f32(tau, g)
    gamma = torch.where(keep, gt, torch.zeros_like(gt))
    e_new = gt - gamma
    return gamma.to(gamma_in.dtype), e_new.to(e.dtype), _nnz(gamma)


def ref_count_ge_fused(g, e, gamma_in, weight, participate, taus, *,
                       include_gamma: bool = False) -> Tensor:
    """Candidate counts of the 1-D operand ``w·g + e`` (``p·(w·g + e) +
    γ_in`` with ``include_gamma``) rebuilt from the raw node inputs; taus
    [B] f32 → int32 [B].

    As in the reference, counted through
    :func:`repro_torch.core.sparsify.count_ge_sorted`, whose integers
    equal the broadcast comparison's for the nondecreasing taus of a
    bisection round.
    """
    op = fused_operand(g[None], e[None],
                       None if gamma_in is None else gamma_in[None],
                       _f32(weight, g).reshape(1),
                       _f32(participate, g).reshape(1),
                       include_gamma=include_gamma)
    return sp.count_ge_sorted(op[0].abs(), taus.to(torch.float32))
