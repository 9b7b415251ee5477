"""Top-Q sparsification primitives (the port of :mod:`repro.core.sparsify`).

Notation follows the paper: ``S(x, Q)`` keeps the Top-Q (by magnitude)
entries of ``x`` and zeroes the rest; ``s(x, Q)`` is the matching 0/1 mask.
Every function works on the last axis, so a ``[W, d]`` level of lanes is
sparsified row by row in one call.

Two implementations, as in the reference:

* exact — ties keep the lower index first, as ``jax.lax.top_k`` does: the
  support is read off a *stable* descending sort of ``|x|``
  (``torch.topk`` breaks ties differently and is not used for it);
* threshold — the branch-and-bisect τ search (:func:`threshold_for_topq`),
  whose candidate counts or digit histogram come from callbacks, so the
  level path streams them through the τ-search kernels.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import to_device

Tensor = torch.Tensor


# Rows this long select instead of sorting. Measured on an NVIDIA H100 80GB
# HBM3 at 700 W, W = 8 rows (tools/torch_topq_select.py crossover):
# the compact wire's per-row path matches the sort at 2^22 entries a row
# and wins above it (1.65 vs 2.92 ms at 2^24); exact Top-Q's sort stays
# ahead to 2^24 (2.36 vs 3.27 ms at 2^22, 7.23 vs 7.44 at 2^24) with 4x the
# scratch, and the select wins on the LM train step's 2·10^8-entry rows
# (17.3 vs 20.4 ms, 2.9 vs 11.1 GB).
_SELECT_D = 1 << 22


def _topq_index(x: Tensor, q: int) -> Tensor:
    """Indices of the q largest ``|x|`` per row, lower index first on ties."""
    order = torch.sort(x.abs(), dim=-1, descending=True, stable=True).indices
    return order[..., :q]


def _select_keep(row: Tensor, q: int) -> Tensor:
    """The Top-Q support of one long row as a bool mask, without a sort:
    every entry above the q-th largest magnitude, then the lowest-index
    entries equal to it until q are kept — the stable descending sort's
    choice. A row holding a NaN takes the sort."""
    mag = row.abs()
    if bool(torch.isnan(mag).any()):
        return torch.zeros_like(row, dtype=torch.bool).scatter_(
            -1, _topq_index(row, q), True)
    top = torch.topk(mag, q, sorted=False).values
    kth = top.amin()
    keep = mag > kth
    # every entry above the q-th magnitude is among the top q: count them
    # there (a bool row's sum makes an int64 copy of the row on the card)
    rest = q - int((top > kth).sum())
    if rest > 0:
        keep[torch.nonzero(mag == kth)[:rest, 0]] = True
    return keep


def _topq_keep(x: Tensor, q: int) -> Tensor:
    """Bool mask of the Top-Q support of each row of ``x``. Rows of at
    least ``_SELECT_D`` entries (the LM train step's segments) go one at a
    time through :func:`_select_keep`: the same support, without the
    sort's int64 indices and scratch over the whole operand."""
    if x.shape[-1] >= _SELECT_D:
        rows = x.reshape(-1, x.shape[-1])
        return torch.stack([_select_keep(r, q) for r in rows]).reshape(
            x.shape)
    return torch.zeros_like(x, dtype=torch.bool).scatter_(
        -1, _topq_index(x, q), True)


def topq(x: Tensor, q: int) -> Tensor:
    """``S(x, Q)``: keep the Q largest-magnitude entries of ``x``."""
    if q <= 0:
        return torch.zeros_like(x)
    if q >= x.shape[-1]:
        return x
    return torch.where(_topq_keep(x, q), x, torch.zeros_like(x))


def topq_mask(x: Tensor, q: int) -> Tensor:
    """``s(x, Q)``: the 0/1 float mask of the Top-Q support of ``x``."""
    if q <= 0:
        return torch.zeros_like(x)
    if q >= x.shape[-1]:
        return torch.ones_like(x)
    return _topq_keep(x, q).to(x.dtype)


def support(x: Tensor) -> Tensor:
    """``1(x)``: indicator of the nonzero entries of ``x`` (float 0/1)."""
    return (x != 0).to(x.dtype)


def mask_union(*masks: Tensor) -> Tensor:
    """``1(m_a + m_b + …)``: union of 0/1 masks, returned as float 0/1."""
    acc = masks[0]
    for m in masks[1:]:
        acc = acc + m
    return (acc > 0).to(acc.dtype)


def nnz(x: Tensor) -> Tensor:
    """``‖x‖₀`` per row as int32."""
    return (x != 0).sum(dim=-1, dtype=torch.int32)


def _dynamic_keep(x: Tensor, q: Tensor) -> Tensor:
    """Boolean Top-q support of ``x`` for a per-row tensor budget ``q``.

    τ = the q-th largest magnitude by full sort, keep ``|x| ≥ τ``. Ties at
    τ may keep more than q entries; q ≤ 0 keeps nothing, q ≥ d everything.
    ``q`` has the shape of ``x`` without its last axis.
    """
    d = x.shape[-1]
    qc = torch.clamp(torch.as_tensor(q, device=x.device).to(torch.int64),
                     0, d)
    mag = x.abs()
    srt = torch.sort(mag, dim=-1, descending=True).values
    tau = torch.gather(srt, -1, torch.clamp(qc - 1, min=0).unsqueeze(-1))
    return (mag >= tau) & (mag > 0) & (qc > 0).unsqueeze(-1)


def topq_dynamic(x: Tensor, q: Tensor) -> Tensor:
    """``S(x, q)`` with a tensor budget ``q`` (one per row)."""
    return torch.where(_dynamic_keep(x, q), x, torch.zeros_like(x))


def topq_mask_dynamic(x: Tensor, q: Tensor) -> Tensor:
    """``s(x, q)``: 0/1 mask counterpart of :func:`topq_dynamic`."""
    return _dynamic_keep(x, q).to(x.dtype)


# ---------------------------------------------------------------------------
# Threshold Top-Q (branch-and-bisect τ search)
#
# Rounding follows the jitted reference: XLA contracts each ``a + b·c`` of
# the bracket arithmetic into one fused multiply-add, so every such site is
# :func:`_fma` (``torch.addcmul``, one rounding), and it turns each division
# by ``branch`` into a product with the reciprocal (:func:`_per_branch`). The sites are the
# candidates ``lo + w·steps``, the narrowed bracket ``lo + j*·w``, the
# tables ``lo + b·w1`` and ``new_lo + w2·branch``, the round-2 candidates
# ``nl + w2·j`` and the final ``nl_B + j*₂·w2_B``.
# ---------------------------------------------------------------------------

_F32_MAX = float(torch.finfo(torch.float32).max)
_TINY = 1e-30                          # bracket floor for all-zero operands
_HI_SCALE = float(np.float32(1 + 1e-6))


def _hi_per_branch(branch: int) -> float:
    return float(np.float32(_HI_SCALE) * (np.float32(1) / np.float32(branch)))


def _fma(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """``a·b + c`` with one rounding, as XLA's contraction computes it."""
    return torch.addcmul(c, a, b)


def _inv(branch: int) -> float:
    return float(np.float32(1) / np.float32(branch))


def _per_branch(x: Tensor, branch: int) -> Tensor:
    """``x / branch`` as the jitted reference computes it: XLA rewrites a
    division by a constant into a product with the f32 reciprocal (the
    two differ in the last bit unless branch is a power of two)."""
    return x * _inv(branch)


def count_ge(mag: Tensor, taus: Tensor) -> Tensor:
    """``counts[j] = #{i : mag_i >= taus_j}`` — int32 [B]."""
    return (mag[:, None] >= taus[None, :]).sum(dim=0, dtype=torch.int32)


def count_ge_batch(mag: Tensor, taus: Tensor) -> Tensor:
    """Batched :func:`count_ge`: mag [W, d], taus [W, B] → int32 [W, B]."""
    return (mag[:, :, None] >= taus[:, None, :]).sum(dim=1,
                                                     dtype=torch.int32)


def count_ge_presorted(smag: Tensor, taus: Tensor) -> Tensor:
    """Candidate counts against magnitudes sorted ascending on the last
    axis: ``d − #{i : smag_i < taus_j}`` by binary search (exact float
    comparisons, so the integers equal :func:`count_ge`'s)."""
    d = smag.shape[-1]
    return (d - torch.searchsorted(smag, taus.contiguous(), side="left")
            ).to(torch.int32)


def count_ge_sorted(mag: Tensor, taus: Tensor) -> Tensor:
    """:func:`count_ge` via sort + binary search (any ``taus`` order);
    rows of a [W, d] ``mag`` pair with rows of a [W, B] ``taus``."""
    return count_ge_presorted(torch.sort(mag, dim=-1).values, taus)


count_ge_sorted_batch = count_ge_sorted


class TauOperand(NamedTuple):
    """The bisection operand of :func:`threshold_for_topq`, as callbacks.

    * ``count(taus)`` → int32 candidate counts ([B] or [W, B]); ``taus``
      are nondecreasing per lane;
    * ``max_abs()`` → max |operand| (f32 scalar or [W]), the initial
      bracket top, with the float expression of a materialized
      ``abs().max()``;
    * ``batched`` → whether the operand carries a [W] lane axis;
    * ``hist(tables)`` → the joint digit histogram ``(D2, F)`` of
      ``tau_impl="hist"`` (see :func:`_hist_digits`); None disables it;
    * ``materialize()`` → the dense operand;
    * ``search(q, branch, rounds)`` → ``(τ, counts [rounds, .., branch])``
      of the whole ``tau_impl="scan"`` search at once, with the scan's
      integers and τ (one launch where the level's lanes are resident);
      None runs the rounds here through ``count``.
    """

    count: Callable[[Tensor], Tensor]
    max_abs: Callable[[], Tensor]
    batched: bool
    hist: Optional[Callable] = None
    materialize: Optional[Callable[[], Tensor]] = None
    search: Optional[Callable] = None


def _max_abs(mag: Tensor) -> Tensor:
    if not mag.numel():
        return torch.zeros(mag.shape[:-1], dtype=torch.float32,
                           device=mag.device)
    return mag.amax(dim=-1)


def tau_operand(x: Tensor, count_fn=None) -> TauOperand:
    """Wrap a materialized ``x`` ([d] or [W, d]) as a :class:`TauOperand`.

    Without ``count_fn`` the magnitudes are sorted once and each round's
    counts are binary searches; with it, ``count_fn(mag, taus)`` counts.
    """
    batched = x.dim() == 2
    mag = x.to(torch.float32).abs()
    if count_fn is None:
        smag = torch.sort(mag, dim=-1).values
        count = lambda taus: count_ge_presorted(smag, taus)  # noqa: E731
    else:
        count = lambda taus: count_fn(mag, taus)             # noqa: E731
    return TauOperand(count=count, max_abs=lambda: _max_abs(mag),
                      batched=batched,
                      hist=lambda tables: _hist_digits(mag, *tables),
                      materialize=lambda: x)


def _hist_tables(lo: Tensor, hi: Tensor, branch: int):
    """Per-bracket round-2 tables, with the scan's own float ops.

    → ``(tau1 [.., b], new_lo [.., b+1], w2 [.., b+1], top_shift
    [.., b+1])``: entry b′ is what the scan computes had round 1 chosen
    ``jstar1 = b′``; ``top_shift[d] = tau_top[d−1]`` (f32 max for d = 0)
    feeds the bracket-top flag F.
    """
    return _hist_tables_w(lo, _per_branch(hi - lo, branch), branch)


def _hist_tables_w(lo: Tensor, w1: Tensor, branch: int):
    """:func:`_hist_tables` given the round-1 width ``w1``.

    ``tau_top = new_lo + w2·branch`` with ``w2 = (new_hi − new_lo)·(1/b)``:
    XLA folds the two constants into one, ``new_lo + (new_hi − new_lo)·k``
    with ``k = fl(fl(1/b)·b)``, and so does this function.
    """
    dev = lo.device
    steps = torch.arange(1, branch + 1, dtype=torch.float32, device=dev)
    bf = torch.arange(0, branch + 1, dtype=torch.float32, device=dev)
    lo_e, w1_e = lo[..., None], w1[..., None]
    tau1 = _fma(w1_e, steps, lo_e)
    new_lo = _fma(bf, w1_e, lo_e)
    diff = (new_lo + w1_e) - new_lo
    w2 = _per_branch(diff, branch)
    k = np.float32(1) / np.float32(branch) * np.float32(branch)
    tau_top = _fma(diff, torch.full_like(diff, float(k)), new_lo)
    top_shift = torch.cat([torch.full_like(tau_top[..., :1], _F32_MAX),
                           tau_top[..., :branch]], dim=-1)
    return tau1, new_lo, w2, top_shift


def _hist_digits(mag: Tensor, tau1: Tensor, new_lo: Tensor, w2: Tensor,
                 top_shift: Tensor):
    """Joint digit histogram of a materialized ``mag`` ([d] or [W, d]).

    → ``(D2 [.., b+1, b+1] i32, F [.., b+1] i32)``: ``D2[r, c] = #{d1 = r,
    d2 = c}``, ``F[r] = #{d1 = r, mag >= top_shift[r]}``. d1 is the round-1
    candidate count (binary search, taus nondecreasing); d2 the round-2
    candidate count inside the element's own bracket (binary search over
    j, valid because ``nl + w2·j`` is nondecreasing in j).
    """
    branch = tau1.shape[-1]
    nb = branch + 1
    d1 = torch.searchsorted(tau1.contiguous(), mag.contiguous(), right=True)
    nl = torch.gather(new_lo, -1, d1)
    w2e = torch.gather(w2, -1, d1)
    te = torch.gather(top_shift, -1, d1)
    lo_i = torch.zeros_like(d1)
    hi_i = torch.full_like(d1, nb)
    for _ in range(max(1, math.ceil(math.log2(nb)))):
        mid = (lo_i + hi_i) // 2
        pred = mag >= _fma(w2e, mid.to(torch.float32), nl)
        take = hi_i - lo_i > 1
        lo_i = torch.where(take & pred, mid, lo_i)
        hi_i = torch.where(take & ~pred, mid, hi_i)
    lead = mag.shape[:-1]
    ones = torch.ones_like(d1, dtype=torch.int32)
    D2 = torch.zeros(lead + (nb * nb,), dtype=torch.int32,
                     device=mag.device).scatter_add_(-1, d1 * nb + lo_i,
                                                     ones)
    F = torch.zeros(lead + (nb,), dtype=torch.int32,
                    device=mag.device).scatter_add_(
                        -1, d1, (mag >= te).to(torch.int32))
    return D2.reshape(lead + (nb, nb)), F


def _suffix_sum(a: Tensor) -> Tensor:
    return torch.flip(torch.cumsum(torch.flip(a, [-1]), -1,
                                   dtype=torch.int32), [-1])


def _take(t: Tensor, idx: Tensor) -> Tensor:
    return torch.gather(t, -1, idx)[..., 0]


def _hist_bisect(new_lo: Tensor, w2: Tensor, D2: Tensor, F: Tensor, q: int,
                 branch: int, rounds: int):
    """The scan's per-round counts and τ from ``(D2, F)``.

    → ``(tau, [counts_round1, ...])``, the same integers and final float
    ops as the streaming scan.
    """
    A = D2.sum(dim=-1, dtype=torch.int32)                   # #{d1 = r}
    zeros2 = torch.zeros(A.shape[:-1] + (2,), dtype=torch.int32,
                         device=A.device)
    suffA = _suffix_sum(torch.cat([A, zeros2], -1))
    c1 = suffA[..., 1:branch + 1]
    jstar1 = (c1 >= q).sum(dim=-1, dtype=torch.int64)
    counts = [c1]
    B = jstar1[..., None]
    nl_B = _take(new_lo, B)
    w2_B = _take(w2, B)
    if rounds == 1:
        return torch.clamp(nl_B, min=_TINY), counts
    S2 = _suffix_sum(D2)                                    # #{d1=r, d2>=c}
    rowS2 = torch.gather(
        S2, -2, B[..., None].expand(B.shape[:-1] + (1, S2.shape[-1])))
    rowS2 = rowS2[..., 0, :]
    zeros1 = torch.zeros(A.shape[:-1] + (1,), dtype=torch.int32,
                         device=A.device)
    a_next = _take(torch.cat([A, zeros1], -1), B + 1)
    f_next = _take(torch.cat([F, zeros1], -1), B + 1)
    s_next2 = _take(suffA, B + 2)
    is_top = torch.arange(1, branch + 1, device=A.device) == branch
    c2 = (rowS2[..., 1:branch + 1] + s_next2[..., None]
          + torch.where(is_top, f_next[..., None], a_next[..., None]))
    counts.append(c2)
    jstar2 = (c2 >= q).sum(dim=-1, dtype=torch.int32)
    tau = _fma(jstar2.to(torch.float32), w2_B, nl_B)
    return torch.clamp(tau, min=_TINY), counts


def _sharded_operand(shards: Sequence[Tensor], count_fn=None) -> TauOperand:
    """The bisection operand of the concatenation of ``shards`` (per-rank
    ``[d_r]`` or ``[W, d_r]`` pieces, each on its own device), as a
    :class:`TauOperand` on the first shard's device.

    The single-controller counterpart of the reference's ``axis_name``
    search: each shard counts (through ``count_fn`` where one is given)
    and histograms its own elements, the counts and ``(D2, F)`` are summed
    as integers, ``max_abs`` is the max of the shards' — so every round sees
    the integers of the whole vector, and τ is the unsharded search's.
    """
    shards = list(shards)
    if not shards:
        raise ValueError("threshold_for_topq needs at least one shard")
    ops = [tau_operand(x, count_fn) for x in shards]
    devs = [x.device for x in shards]
    home = devs[0]
    batched = ops[0].batched
    if any(op.batched != batched for op in ops):
        raise ValueError("shards must all be [d] or all [W, d]")

    def total(parts):
        out = to_device(parts[0], home)
        for t in parts[1:]:
            out = out + to_device(t, home)
        return out

    def count(taus):
        return total([op.count(to_device(taus, dev))
                      for op, dev in zip(ops, devs)])

    def max_abs():
        return torch.stack([to_device(op.max_abs(), home)
                            for op in ops]).amax(0)

    def hist(tables):
        parts = [op.hist(tuple(to_device(t, dev) for t in tables))
                 for op, dev in zip(ops, devs)]
        return total([p[0] for p in parts]), total([p[1] for p in parts])

    return TauOperand(count=count, max_abs=max_abs, batched=batched,
                      hist=hist)


def threshold_for_topq(x, q: int, *, branch: int = 64, rounds: int = 3,
                       count_fn=None,
                       operand_fn: Optional[TauOperand] = None,
                       tau_impl: str = "scan", with_counts: bool = False):
    """Magnitude threshold ``τ`` with ``count(|x| >= τ) ≥ q``.

    Branch-and-bisect: each round places ``branch`` candidates inside the
    current bracket, counts the elements at or above each, and narrows the
    bracket ``branch``-fold, so ``rounds`` rounds resolve ``branch**rounds``
    bins. Invariant: ``count(|x| >= lo) >= q``.

    ``x`` is ``[d]`` or ``[W, d]`` (every lane runs its own bracket and a
    ``[W]`` τ is returned). ``count_fn(mag, taus)`` replaces the default
    sorted-search counts; ``operand_fn`` (a :class:`TauOperand`) replaces
    ``x`` entirely. ``tau_impl="hist"`` (rounds 1 or 2) folds the search
    into one joint digit histogram with the scan's integers and τ.
    ``with_counts=True`` also returns the per-round counts, stacked
    ``[rounds, .., branch]``.
    An ``operand_fn`` with a ``search`` runs the whole scan through it.

    ``x`` may also be a sequence of per-rank shards (the reference's
    ``axis_name`` search over a mesh, here on one controller): ``q`` is the
    global budget, the counts (or ``(D2, F)``) are summed over the shards
    and the bracket top is their max (:func:`_sharded_operand`), so τ and
    the counts are the unsharded search's.

    With none of ``count_fn``, ``operand_fn``, ``with_counts`` and an
    unsharded ``x`` the scan is count-free: the rounds read counts only
    through ``count >= q``, and ``#{|x| >= t} >= q`` holds exactly when
    t ≤ the q-th largest |x|, so one top-q selection answers every
    candidate of every round with the same τ.
    """
    if tau_impl not in ("scan", "hist"):
        raise ValueError(f"unknown tau_impl {tau_impl!r}")
    sharded = isinstance(x, (list, tuple))
    if sharded and operand_fn is None:
        operand_fn = _sharded_operand(x, count_fn)
    if (tau_impl == "scan" and operand_fn is not None
            and operand_fn.search is not None):
        tau, counts = operand_fn.search(q, branch, rounds)
        return (tau, counts) if with_counts else tau
    kth = None
    if (tau_impl == "scan" and operand_fn is None and count_fn is None
            and not with_counts):
        operand = None
        mag = x.to(torch.float32).abs()
        batched = x.dim() == 2
        d = mag.shape[-1]
        hi = _max_abs(mag)
        if q <= 0:
            kth = torch.full_like(hi, math.inf)          # count >= q always
        elif q > d:
            kth = torch.full_like(hi, -math.inf)         # count < q always
        else:
            kth = torch.topk(mag, q, dim=-1, sorted=False).values.amin(-1)
    else:
        operand = tau_operand(x, count_fn) if operand_fn is None \
            else operand_fn
        batched = operand.batched
        hi = operand.max_abs()
    # strictly above the max ⇒ count(hi) = 0 < q; the floor covers x = 0
    hi_max = torch.clamp(hi, min=_TINY)
    hi = hi_max * _HI_SCALE
    lo = torch.zeros_like(hi)

    if tau_impl == "hist":
        if rounds not in (1, 2):
            raise ValueError("tau_impl='hist' folds the whole search into "
                             "one histogram pass; rounds must be 1 or 2, "
                             f"got {rounds}")
        if branch > 1024:
            raise ValueError("tau_impl='hist' cross-bracket count exactness "
                             f"needs branch <= 1024, got {branch}")
        if operand.hist is None:
            raise ValueError("operand_fn has no hist implementation")
        # XLA folds the constant bracket bottom and the two constant
        # factors of the width, (max·c)·(1/b), into max·fl(c·(1/b))
        tables = _hist_tables_w(lo, hi_max * _hi_per_branch(branch), branch)
        D2, F = operand.hist(tables)
        tau, counts = _hist_bisect(tables[1], tables[2], D2, F, q, branch,
                                   rounds)
        return (tau, torch.stack(counts)) if with_counts else tau

    steps = torch.arange(1, branch + 1, dtype=torch.float32,
                         device=hi.device)
    ys = []
    for _ in range(rounds):
        # one round is straight-line code for XLA: the bracket bottom is
        # the constant 0 and the width folds as in the hist tables
        w = (hi_max * _hi_per_branch(branch) if rounds == 1
             else _per_branch(hi - lo, branch))
        taus = (_fma(w[:, None], steps, lo[:, None]) if batched
                else _fma(w, steps, lo))
        if kth is not None:
            keeps_q = (kth[..., None] if batched else kth) >= taus
        else:
            counts = operand.count(taus)
            keeps_q = counts >= q
            ys.append(counts)
        # counts fall as τ rises; jstar = #{j : counts_j >= q} is the
        # largest candidate (1-based) that still keeps q
        jstar = keeps_q.sum(dim=-1, dtype=torch.int32)
        # XLA recomputes w inside the fusion of ``new_lo + w`` and
        # contracts it: new_hi = fma(hi − lo, 1/b, new_lo)
        new_lo = _fma(jstar.to(torch.float32), w, lo)
        hi = _fma(hi - lo, torch.full_like(hi, _inv(branch)), new_lo)
        lo = new_lo
    tau = torch.clamp(lo, min=_TINY)
    return (tau, torch.stack(ys)) if with_counts else tau


def topq_by_threshold(x: Tensor, q: int, *, branch: int = 64,
                      rounds: int = 3, count_fn=None,
                      tau_impl: str = "scan") -> Tensor:
    """Approximate ``S(x, Q)`` through the bisection threshold (≥ q
    survivors)."""
    tau = threshold_for_topq(x, q, branch=branch, rounds=rounds,
                             count_fn=count_fn, tau_impl=tau_impl)
    if x.dim() == 2:
        tau = tau[:, None]
    return torch.where(x.abs() >= tau, x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Compact sparse representation
# ---------------------------------------------------------------------------

def compact(x: Tensor, q: int):
    """Dense ``[..., d]`` → ``(values [..., q], indices [..., q] i32,
    count [...] i32)``, row by row over any leading axes.

    The slots hold the nonzeros of ``x`` in index order (lossless when
    ``x`` has at most q nonzeros); unused slots carry value 0 and the
    one-past-end index d, which :func:`scatter` drops.
    """
    d = x.shape[-1]
    if d >= _SELECT_D:
        return _compact_rows(x, q)
    is_nz = x != 0
    order = torch.sort((~is_nz).to(torch.int8), dim=-1, stable=True).indices
    take = order[..., :q]
    valid = torch.gather(is_nz, -1, take)
    picked = torch.gather(x, -1, take)
    idx = torch.where(valid, take, torch.full_like(take, d)).to(torch.int32)
    vals = torch.where(valid, picked, torch.zeros_like(picked))
    return vals, idx, is_nz.sum(dim=-1, dtype=torch.int32)


def _compact_rows(x: Tensor, q: int):
    """:func:`compact` of long rows one at a time from their nonzero
    positions (ascending, as the stable sort orders them), without sorting
    the whole operand."""
    d = x.shape[-1]
    rows = x.reshape(-1, d)
    vals = torch.zeros((rows.shape[0], q), dtype=x.dtype, device=x.device)
    idx = torch.full((rows.shape[0], q), d, dtype=torch.int32,
                     device=x.device)
    count = torch.empty((rows.shape[0],), dtype=torch.int32, device=x.device)
    for i, row in enumerate(rows):
        nz = torch.nonzero(row)[:, 0]
        count[i] = nz.numel()
        nz = nz[:q]
        vals[i, :nz.numel()] = row[nz]
        idx[i, :nz.numel()] = nz.to(torch.int32)
    lead = x.shape[:-1]
    return (vals.reshape(lead + (q,)), idx.reshape(lead + (q,)),
            count.reshape(lead))


def scatter(vals: Tensor, idx: Tensor, d: int) -> Tensor:
    """Compact ``(values, indices)`` → dense ``[..., d]``; index d is
    dropped. The indices of a row are distinct (but for the dropped
    sentinel), so every kept value lands on a zero and the result does not
    depend on the order of the adds."""
    out = torch.zeros(vals.shape[:-1] + (d + 1,), dtype=vals.dtype,
                      device=vals.device)
    out.scatter_add_(-1, idx.to(torch.int64), vals)
    return out[..., :d]
