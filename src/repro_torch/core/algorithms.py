"""The paper's five sparse incremental-aggregation algorithms (the port of
:mod:`repro.core.algorithms`).

Each algorithm is a *node step*: what client k does with its own effective
gradient ``g_k`` and the incoming partial aggregate ``γ_{k+1}`` before
forwarding ``γ_k`` toward the parameter server. Everything is dense
d-vectors with bit-exact §V communication accounting.

JAX's ``vmap`` over the W slots of a level becomes a written-out lane axis:
the unfused ``step_*`` bodies below take ``[W, d]`` lanes with ``[W]``
per-lane scalars. Two execution forms share them: the scalar
:func:`node_step` (one node, one d-vector — the sequential chain) and the
batched :func:`level_step` (all W slots of a padded schedule level — the
plan executor). When the fused path is on (:func:`fused_node_steps`) a
level runs through the level kernels of :mod:`repro_torch.kernels.ops`:
``cl_fuse_level`` for CL-SIA and CL-TC-SIA (``cl_fuse_select_level``, the
exact Top-Q support and the fuse in one launch, on resident lanes);
for SIA, RE-SIA and TC-SIA ``ia_fuse_select_level`` on resident lanes
(the keep mask — exact Top-Q support or a given τ — EF, sparsify and the
IA combine in one launch), else, and under a per-lane ``q_budget``,
``sparsify_ef_level`` then ``chain_accum_level``.

Every ``a*b + c`` that XLA contracts to a fused multiply-add in the jitted
reference is a :func:`torch.addcmul` here, so both packages round alike.

Naming (paper §VI): Alg1=SIA, Alg2=RE-SIA, Alg3=CL-SIA, Alg4=TC-SIA,
Alg5=CL-TC-SIA.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import math
import warnings
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import sparsify as sp
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

Tensor = torch.Tensor


class AggKind(str, enum.Enum):
    SIA = "sia"                # Alg 1 (SoA baseline)
    RE_SIA = "re_sia"          # Alg 2
    CL_SIA = "cl_sia"          # Alg 3
    TC_SIA = "tc_sia"          # Alg 4
    CL_TC_SIA = "cl_tc_sia"    # Alg 5
    DENSE_IA = "dense_ia"      # IA without sparsification (upper baseline)
    ROUTING = "routing"        # conventional routing (no IA; cost model only)


@dataclasses.dataclass(frozen=True)
class AggConfig:
    """Static configuration of a sparse-IA aggregator.

    ``q`` is the per-hop budget; the time-correlated variants split it into
    ``q_global`` and ``q_local`` (paper: Q_L = 0.1·Q, Q_G = Q − Q_L).
    ``omega`` is the payload word size in bits; each locally-indexed nonzero
    also costs ⌈log₂ d⌉ index bits.

    ``kernel_mode`` selects the node-step path (:func:`repro_torch.kernels.
    ops.resolve`): ``"auto"``/``"always"`` fused, with the CUDA kernels for
    CUDA tensors; ``"never"`` unfused; ``"ref"`` fused with plain bodies.
    ``err_sq_mode`` is ``"jnp"`` (a row sum of e′², comparable with the
    unfused bodies) or ``"kernel"`` (the pinned in-kernel fold order).
    ``wire_dtype`` is the dtype of the values on the compact wire of the
    client-per-rank device backend (:mod:`repro_torch.agg.device`):
    ``"float32"`` matches ω = 32, ``"bfloat16"`` is the ω = 16
    quantization knob, taken only under ``wire="compact"``.

    ``topq_impl`` is ``"exact"`` (the full-sort Top-Q) or ``"threshold"``
    (branch-and-bisect: ``hist_rounds`` rounds of ``hist_branch``
    candidates, ≥ q survivors). Its τ search ``tau_impl`` is ``"scan"`` (a
    count pass per round) or ``"hist"`` (one joint digit histogram for
    ``hist_rounds`` ∈ {1, 2}, with the scan's integers and τ).
    """

    kind: AggKind = AggKind.CL_SIA
    q: int = 78
    q_global: int = 0
    q_local: int = 0
    omega: int = 32
    topq_impl: str = "exact"
    hist_branch: int = 64
    hist_rounds: int = 3
    tau_impl: str = "scan"
    err_sq_mode: str = "jnp"
    wire_dtype: str = "float32"
    kernel_mode: str = "auto"

    def __post_init__(self):
        if self.kind in (AggKind.TC_SIA, AggKind.CL_TC_SIA):
            if self.q_global <= 0 and self.q_local <= 0 and self.q > 0:
                ql = max(1, round(0.1 * self.q))          # paper's split
                object.__setattr__(self, "q_local", ql)
                object.__setattr__(self, "q_global", self.q - ql)
        if self.kernel_mode not in kops.MODES:
            raise ValueError(f"unknown kernel_mode {self.kernel_mode!r} "
                             f"(expected one of {kops.MODES})")
        if self.topq_impl not in ("exact", "threshold"):
            raise ValueError(f"unknown topq_impl {self.topq_impl!r}")
        if self.tau_impl not in ("scan", "hist"):
            raise ValueError(f"unknown tau_impl {self.tau_impl!r} "
                             f"(expected 'scan' or 'hist')")
        if self.tau_impl == "hist" and self.hist_rounds not in (1, 2):
            raise ValueError(
                "tau_impl='hist' folds the whole τ search into one "
                f"histogram pass; hist_rounds must be 1 or 2, got "
                f"{self.hist_rounds}")
        if self.err_sq_mode not in ("jnp", "kernel"):
            raise ValueError(f"unknown err_sq_mode {self.err_sq_mode!r} "
                             f"(expected 'jnp' or 'kernel')")
        if self.wire_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown wire_dtype {self.wire_dtype!r} "
                             f"(expected 'float32' or 'bfloat16')")
        if self.kind not in (AggKind.DENSE_IA, AggKind.ROUTING):
            if self.q < 0:
                raise ValueError("q must be non-negative for sparsified "
                                 "aggregation")
            if self.q == 0:
                warnings.warn(
                    "AggConfig q=0: nothing will be transmitted and the "
                    "model will not update", stacklevel=2)

    def topq_fn(self) -> Callable[[Tensor, int], Tensor]:
        """``S(x, q)`` on the last axis under ``topq_impl``."""
        if self.topq_impl == "exact":
            return sp.topq
        return lambda x, q: sp.topq_by_threshold(
            x, q, branch=self.hist_branch, rounds=self.hist_rounds,
            tau_impl=self.tau_impl)

    def topq_mask_fn(self) -> Callable[[Tensor, int], Tensor]:
        """``s(x, q)`` on the last axis under ``topq_impl``."""
        if self.topq_impl == "exact":
            return sp.topq_mask

        def mask(x, q):
            tau = sp.threshold_for_topq(
                x, q, branch=self.hist_branch, rounds=self.hist_rounds,
                tau_impl=self.tau_impl)
            return (x.abs() >= (tau if x.dim() == 1 else _col(tau))
                    ).to(x.dtype)
        return mask


class HopStats(NamedTuple):
    """Per-hop accounting. ``bits`` follows §V exactly: globally-masked
    values cost ω each (indices implicit), locally-indexed nonzeros cost
    ω + ⌈log₂ d⌉ each. Leaves are per-lane ``[W]`` (or 0-d for one node)."""

    nnz_out: Tensor         # ‖γ_k‖₀ transmitted by this hop
    nnz_global: Tensor      # ‖Γ_k‖₀ part (0 for non-TC algorithms)
    nnz_local: Tensor       # ‖Λ_k‖₀ part (= nnz_out for non-TC)
    bits: Tensor            # exact transmitted bits for this hop (f32)
    err_sq: Tensor          # ‖e_k^t‖² sparsification error after this hop


class NodeCtx(NamedTuple):
    """Round-constant context of a node step.

    ``global_mask`` is the TCS mask m^t (zeros for non-TC algorithms),
    lane-shared ``[d]`` or per-lane ``[W, d]``. ``participate`` ∈ {0, 1}
    per lane: a non-participating node forwards γ unchanged and banks its
    entire g̃ into error feedback. ``q_budget`` (optional int ``[W]``)
    overrides the local Top-Q budget per lane.
    """

    global_mask: Tensor
    participate: Tensor
    q_budget: Optional[Tensor] = None


def index_bits(d: int) -> int:
    """⌈log₂ d⌉ — bits to address one coordinate of a length-d vector."""
    return max(1, math.ceil(math.log2(d)))


def _bits(cfg: AggConfig, d: int, nnz_global: Tensor,
          nnz_local: Tensor) -> Tensor:
    # float32, like the reference: bit counts of large models overflow int32
    ib = index_bits(d)
    return (cfg.omega * nnz_global.to(torch.float32)
            + (cfg.omega + ib) * nnz_local.to(torch.float32))


def _col(v: Tensor) -> Tensor:
    """[W] per-lane scalars → [W, 1], broadcasting over d."""
    return v[:, None]


def _topq_local(cfg: AggConfig, ctx: NodeCtx, x: Tensor, q: int) -> Tensor:
    """Local Top-Q values under the node's budget (static q or q_budget)."""
    if ctx.q_budget is None:
        return cfg.topq_fn()(x, q)
    return sp.topq_dynamic(x, ctx.q_budget)


def _topq_mask_local(cfg: AggConfig, ctx: NodeCtx, x: Tensor,
                     q: int) -> Tensor:
    """Local Top-Q mask under the node's budget (static q or q_budget)."""
    if ctx.q_budget is None:
        return cfg.topq_mask_fn()(x, q)
    return sp.topq_mask_dynamic(x, ctx.q_budget)


def _lane_err_sq(e_new: Tensor) -> Tensor:
    return (e_new.to(torch.float32) ** 2).sum(dim=-1)


# ---------------------------------------------------------------------------
# Fused whole-level node steps (the kernel hot path)
# ---------------------------------------------------------------------------

_FUSED_KINDS = (AggKind.SIA, AggKind.RE_SIA, AggKind.CL_SIA, AggKind.TC_SIA,
                AggKind.CL_TC_SIA)


def fused_node_steps(cfg: AggConfig, *operands: Tensor) -> bool:
    """True when ``cfg`` runs node steps through the fused level path.

    The algorithm has a fused form, ``cfg.kernel_mode`` is not
    ``"never"``, and the operands promote to float32 (the kernels compute
    in f32; an all-bf16 operand set falls back to the unfused bodies).
    """
    if cfg.kind not in _FUSED_KINDS or cfg.kernel_mode == "never":
        return False
    if not operands:
        return True
    dtype = functools.reduce(torch.promote_types,
                             [t.dtype for t in operands])
    return dtype == torch.float32


def _lane_inf(w: int, device) -> Tensor:
    return torch.full((w,), math.inf, dtype=torch.float32, device=device)


def _tau_operand(cfg: AggConfig, g, e, gam, w, p, gm=None, cohorts=0, *,
                 include_gamma: bool = False) -> sp.TauOperand:
    """The level's sparsifier operand as a :class:`~repro_torch.core.
    sparsify.TauOperand` over the raw node inputs.

    The threshold τ search runs in one ``tau_search_fused_level`` launch
    where the lanes are resident (:func:`repro_torch.kernels.ops.
    resident_level`), else counts through ``count_ge_fused_level`` once a
    round (or one ``hist_topq_level`` pass under ``tau_impl="hist"``);
    each rebuilds the operand from the raw inputs. ``materialize()`` (the
    exact and dynamic-budget sparsifiers, which sort it) and ``max_abs()``
    use the same float expression (:func:`repro_torch.kernels.ref.
    fused_operand`), so every path selects what the kernels' τ test would.
    A cohort-shared ``[B, d]`` mask (``cohorts=B``) goes to the kernels as
    it is.
    """
    mode = cfg.kernel_mode

    def materialize():
        return kref.fused_operand(g, e, gam, w, p, gm,
                                  include_gamma=include_gamma,
                                  gmask_cohorts=cohorts)

    def count(taus):
        return kops.count_ge_fused_level(g, e, gam, w, p, taus, gm,
                                         include_gamma=include_gamma,
                                         gmask_cohorts=cohorts, mode=mode)

    def hist(tables):
        return kops.hist_topq_level(g, e, gam, w, p, tables, gm,
                                    include_gamma=include_gamma,
                                    gmask_cohorts=cohorts, mode=mode)

    def search(q, branch, rounds):
        return kops.tau_search_fused_level(
            g, e, gam, w, p, gm, q=q, branch=branch, rounds=rounds,
            include_gamma=include_gamma, gmask_cohorts=cohorts, mode=mode)

    resident = kops.resident_level(g.shape[-1], cfg.hist_branch)
    return sp.TauOperand(count=count,
                         max_abs=lambda: sp._max_abs(materialize().abs()),
                         batched=True, hist=hist, materialize=materialize,
                         search=search if resident else None)


def _lane_sparsifier_state(cfg: AggConfig, operand: sp.TauOperand, q: int,
                           p: Tensor, qb: Optional[Tensor]):
    """Per-lane ``(mask_in, tau)`` such that ``keep = |x| ≥ τ ∨ mask_in``
    reproduces the unfused ``_topq_local`` keep set lane by lane:

    * dynamic budgets → the sort-threshold keep mask, τ = +inf;
    * exact Top-Q → the Top-Q support mask, τ = +inf;
    * threshold Top-Q → no mask, τ from the branch-and-bisect over the
      operand's callbacks (the count or histogram kernels).

    Lanes with p = 0 keep nothing (mask zeroed, τ = +inf).
    """
    w = p.shape[0]
    if qb is not None:
        mask = sp.topq_mask_dynamic(operand.materialize(), qb)
        return mask * _col(p), _lane_inf(w, p.device)
    if cfg.topq_impl == "threshold":
        tau = sp.threshold_for_topq(
            None, q, branch=cfg.hist_branch, rounds=cfg.hist_rounds,
            operand_fn=operand, tau_impl=cfg.tau_impl)
        return None, torch.where(p > 0, tau, _lane_inf(w, p.device))
    mask = sp.topq_mask(operand.materialize(), q)
    return mask * _col(p), _lane_inf(w, p.device)


def _resident_exact(cfg: AggConfig, d: int, budgets: bool) -> bool:
    """Exact Top-Q with a static q on resident lanes: the CL support and
    the CL fuse in one ``cl_fuse_select_level`` launch."""
    return (not budgets and cfg.topq_impl == "exact"
            and kops.resident_level(d))


def _ia_level(cfg, g, gam, e, w, p, gm, qb, valid, cohorts, q):
    """An SIA, RE-SIA or TC-SIA level (``gm`` None but for TC-SIA) →
    ``(γ_out, e′, nnz, nnz_off)`` (+ the pinned ‖e′‖² under
    ``err_sq_mode="kernel"``).

    On resident lanes with a static q, one ``ia_fuse_select_level``: the
    exact Top-Q support of q, or τ from the level's search (threshold
    Top-Q). Otherwise the keep mask and τ of
    :func:`_lane_sparsifier_state` (RE-SIA and TC-SIA add their unions),
    then ``sparsify_ef_level`` and ``chain_accum_level``.
    """
    we = cfg.err_sq_mode == "kernel"
    mode = cfg.kernel_mode
    op = _tau_operand(cfg, g, e, None, w, p, gm, cohorts)
    if qb is None and kops.resident_level(g.shape[-1]):
        tau = None
        if cfg.topq_impl == "threshold":
            tau = sp.threshold_for_topq(
                None, q, branch=cfg.hist_branch, rounds=cfg.hist_rounds,
                operand_fn=op, tau_impl=cfg.tau_impl)
        return kops.ia_fuse_select_level(
            g, e, gam, w, p, valid, gm, kind=cfg.kind,
            q=q if tau is None else None, tau=tau, gmask_cohorts=cohorts,
            with_err=we, mode=mode)
    if cfg.kind == AggKind.SIA:
        mask, tau = _lane_sparsifier_state(cfg, op, q, p, qb)
    elif cfg.kind == AggKind.RE_SIA:
        m_in = sp.support(gam)
        if qb is None and cfg.topq_impl == "threshold":
            _, tau = _lane_sparsifier_state(cfg, op, q, p, qb)
            mask = m_in * _col(p)
        else:
            m_l, tau = _lane_sparsifier_state(cfg, op, q,
                                              torch.ones_like(p), qb)
            mask = sp.mask_union(m_l, m_in) * _col(p)
    else:
        # the mask algebra takes a cohort-shared mask per lane, the
        # kernels take it compact
        gme = kref.expand_gmask(gm, g.shape[0], cohorts)
        m_k, tau = _lane_sparsifier_state(cfg, op, q, torch.ones_like(p),
                                          qb)
        m_in = torch.clamp(sp.support(gam) - gme, 0, 1)
        if m_k is None:
            # threshold Top-Q: materialize the local mask to union it with
            # the global and incoming masks, as the unfused topq_mask_fn
            # does
            x = op.materialize()
            m_k = (x.abs() >= _col(tau)).to(x.dtype)
            tau = _lane_inf(g.shape[0], g.device)
        mask = sp.mask_union(torch.broadcast_to(gme, m_k.shape), m_k,
                             m_in) * _col(p)
    out = kops.sparsify_ef_level(g, e, mask, w, tau, valid, with_err=we,
                                 mode=mode)
    gout, nnz, nnz_off = kops.chain_accum_level(gam, out[0], valid, gm,
                                                gmask_cohorts=cohorts,
                                                mode=mode)
    return (gout, out[1], nnz, nnz_off) + out[3:]


def _stats_no_gmask(cfg, d, nnz, e_new, err=None) -> HopStats:
    zeros = torch.zeros_like(nnz)
    return HopStats(nnz_out=nnz, nnz_global=zeros, nnz_local=nnz,
                    bits=_bits(cfg, d, zeros, nnz),
                    err_sq=_lane_err_sq(e_new) if err is None else err)


def _stats_gmask(cfg, d, gm, nnz, nnz_off, e_new, cohorts=0,
                 err=None) -> HopStats:
    # one count per mask row ([d] → one, [W, d] → per lane, [B, d] → per
    # cohort, repeated to its cohort-major lanes)
    nz_rows = (gm > 0).sum(dim=-1, keepdim=True, dtype=torch.int32)
    nz_g = kref.expand_gmask(nz_rows, nnz.shape[0], cohorts)[..., 0]
    nz_g = torch.broadcast_to(nz_g, nnz.shape)
    return HopStats(nnz_out=nnz, nnz_global=nz_g, nnz_local=nnz_off,
                    bits=_bits(cfg, d, nz_g, nnz_off),
                    err_sq=_lane_err_sq(e_new) if err is None else err)


def _fused_level_sia(cfg, g, gam, e, w, p, gm, qb, valid, cohorts=0):
    # SIA and RE-SIA: no global mask (``_ia_level`` reads the kind)
    out = _ia_level(cfg, g, gam, e, w, p, None, qb, valid, 0, cfg.q)
    we = cfg.err_sq_mode == "kernel"
    return out[0], out[1], _stats_no_gmask(cfg, g.shape[-1], out[2], out[1],
                                           out[4] if we else None)


def _fused_level_tc_sia(cfg, g, gam, e, w, p, gm, qb, valid, cohorts=0):
    out = _ia_level(cfg, g, gam, e, w, p, gm, qb, valid, cohorts,
                    cfg.q_local)
    we = cfg.err_sq_mode == "kernel"
    return out[0], out[1], _stats_gmask(cfg, g.shape[-1], gm, out[2],
                                        out[3], out[1], cohorts,
                                        out[4] if we else None)


def _fused_level_cl_sia(cfg, g, gam, e, w, p, gm, qb, valid, cohorts=0):
    we = cfg.err_sq_mode == "kernel"
    if _resident_exact(cfg, g.shape[-1], qb is not None):
        out = kops.cl_fuse_select_level(g, e, gam, w, p, valid, q=cfg.q,
                                        with_err=we, mode=cfg.kernel_mode)
    else:
        op = _tau_operand(cfg, g, e, gam, w, p, include_gamma=True)
        mask, tau = _lane_sparsifier_state(cfg, op, cfg.q,
                                           torch.ones_like(p), qb)
        out = kops.cl_fuse_level(g, e, gam, w, tau, p, valid, mask_in=mask,
                                 with_err=we, mode=cfg.kernel_mode)
    gout, e_new, nnz = out[0], out[1], out[2]
    return gout, e_new, _stats_no_gmask(cfg, g.shape[-1], nnz, e_new,
                                        out[4] if we else None)


def _fused_level_cl_tc_sia(cfg, g, gam, e, w, p, gm, qb, valid, cohorts=0):
    we = cfg.err_sq_mode == "kernel"
    if _resident_exact(cfg, g.shape[-1], qb is not None):
        out = kops.cl_fuse_select_level(g, e, gam, w, p, valid, gm,
                                        q=cfg.q_local, gmask_cohorts=cohorts,
                                        with_err=we, mode=cfg.kernel_mode)
    else:
        op = _tau_operand(cfg, g, e, gam, w, p, gm, cohorts,
                          include_gamma=True)
        mask, tau = _lane_sparsifier_state(cfg, op, cfg.q_local,
                                           torch.ones_like(p), qb)
        out = kops.cl_fuse_level(g, e, gam, w, tau, p, valid, gmask=gm,
                                 mask_in=mask, gmask_cohorts=cohorts,
                                 with_err=we, mode=cfg.kernel_mode)
    gout, e_new, nnz, nnz_off = out[:4]
    return gout, e_new, _stats_gmask(cfg, g.shape[-1], gm, nnz, nnz_off,
                                     e_new, cohorts, out[4] if we else None)


_FUSED_LEVEL = {
    AggKind.SIA: _fused_level_sia,
    AggKind.RE_SIA: _fused_level_sia,
    AggKind.CL_SIA: _fused_level_cl_sia,
    AggKind.TC_SIA: _fused_level_tc_sia,
    AggKind.CL_TC_SIA: _fused_level_cl_tc_sia,
}


def _f32(x: Tensor) -> Tensor:
    return x.to(torch.float32).contiguous()


def _mask_lanes(ok: Tensor, stats: HopStats) -> HopStats:
    return HopStats(*(torch.where(ok, s, torch.zeros_like(s))
                      for s in stats))


def _run_fused_level(cfg, g, gamma_in, e, weight, participate, global_mask,
                     q_budget, valid, cohorts=0):
    w_lanes = g.shape[0]
    # a lane-shared [d] TCS mask stays 1-D all the way into the kernels, a
    # cohort-shared [B, d] one (cohorts=B, lanes cohort-major) [B, d]
    gm = _f32(global_mask)
    qb = None if q_budget is None else q_budget.to(torch.int32)
    v = (torch.ones((w_lanes,), dtype=torch.float32, device=g.device)
         if valid is None else _f32(valid))
    gout, e_new, stats = _FUSED_LEVEL[cfg.kind](
        cfg, _f32(g), _f32(gamma_in), _f32(e), _f32(weight),
        _f32(participate), gm, qb, v, cohorts)
    # padding lanes count nothing: the kernels zero their outputs and
    # counts, but the global-mask word count is lane-agnostic
    return gout, e_new, _mask_lanes(v > 0, stats)


def _fused_scalar(cfg: AggConfig, g, gamma_in, e, weight, ctx: NodeCtx):
    """One node (d-vectors) as a W=1 fused level, or None when unfused."""
    if g.dim() != 1 or not fused_node_steps(cfg, g, e, gamma_in):
        return None
    qb = (None if ctx.q_budget is None
          else torch.as_tensor(ctx.q_budget).reshape(1))
    gout, e_new, stats = _run_fused_level(
        cfg, g[None], gamma_in[None], e[None],
        torch.as_tensor(weight, device=g.device).reshape(1),
        torch.as_tensor(ctx.participate, device=g.device).reshape(1),
        ctx.global_mask, qb, None)
    stats = HopStats(*(s[0] for s in stats))
    if cfg.err_sq_mode == "jnp":
        stats = stats._replace(err_sq=(e_new[0].to(torch.float32) ** 2).sum())
    return gout[0], e_new[0], stats


# ---------------------------------------------------------------------------
# Unfused node steps on lanes. Signature:
#   (cfg, g [W,d], gamma_in [W,d], e [W,d], weight [W], ctx)
#     -> (gamma_out [W,d], e_new [W,d], HopStats [W])
# ---------------------------------------------------------------------------

def _finalize(cfg: AggConfig, d: int, gamma_out: Tensor, e_new: Tensor,
              global_mask: Tensor):
    lam = gamma_out * (1 - global_mask)
    nz_l = sp.nnz(lam)
    # Γ is sent densely in the Q_G known slots → Q_G words whenever a
    # global mask is active, regardless of zero values inside it
    nz_g = torch.broadcast_to(
        (global_mask > 0).sum(dim=-1, dtype=torch.int32), nz_l.shape)
    stats = HopStats(nnz_out=sp.nnz(gamma_out), nnz_global=nz_g,
                     nnz_local=nz_l, bits=_bits(cfg, d, nz_g, nz_l),
                     err_sq=_lane_err_sq(e_new))
    return gamma_out, e_new, stats


def _masked(mask: Tensor, x: Tensor) -> Tensor:
    """``mask · x`` for a 0/1 mask made from a comparison. XLA rewrites
    that product to ``select(mask, x, 0)``, which gives +0.0 (not −0.0)
    off the mask; the port does the same so the zeros' signs agree."""
    return torch.where(mask > 0, x, torch.zeros_like(x))


def _feedback(g, e, weight):
    """g̃ = w·g + e, one rounding (the reference's contracted FMA)."""
    return torch.addcmul(e, _col(weight), g)


def step_sia(cfg, g, gamma_in, e, weight, ctx: NodeCtx):
    """Alg 1 — SoA sparse IA: local Top-Q then add."""
    gt = _feedback(g, e, weight)                         # line 2
    gbar = _topq_local(cfg, ctx, gt, cfg.q)              # line 3
    gbar = gbar * _col(ctx.participate)
    e_new = gt - gbar                                    # line 4
    gamma_out = gbar + gamma_in                          # line 5
    return _finalize(cfg, g.shape[-1], gamma_out, e_new, torch.zeros_like(g))


def step_re_sia(cfg, g, gamma_in, e, weight, ctx: NodeCtx):
    """Alg 2 — reduced-error: transmit inside union(local Top-Q, incoming)."""
    gt = _feedback(g, e, weight)                         # line 2
    m_local = _topq_mask_local(cfg, ctx, gt, cfg.q)      # line 3
    m_in = sp.support(gamma_in)                          # line 4
    m = sp.mask_union(m_local, m_in)                     # line 5
    gbar = _masked(m, gt) * _col(ctx.participate)
    e_new = gt - gbar                                    # line 6
    gamma_out = gbar + gamma_in                          # line 7
    return _finalize(cfg, g.shape[-1], gamma_out, e_new, torch.zeros_like(g))


def step_cl_sia(cfg, g, gamma_in, e, weight, ctx: NodeCtx):
    """Alg 3 — constant-length: aggregate then Top-Q. ‖γ_out‖₀ ≤ Q."""
    p = _col(ctx.participate)
    gt = _feedback(g, e, weight)                         # line 2
    gamma_tilde = torch.addcmul(gamma_in, p, gt)         # line 3
    gamma_out = _topq_local(cfg, ctx, gamma_tilde, cfg.q)    # line 4
    e_new = gamma_tilde - gamma_out                      # line 5
    # a straggler forwards γ unchanged and banks its whole g̃
    gamma_out = torch.where(p > 0, gamma_out, gamma_in)
    e_new = torch.where(p > 0, e_new, gt)
    return _finalize(cfg, g.shape[-1], gamma_out, e_new, torch.zeros_like(g))


def step_tc_sia(cfg, g, gamma_in, e, weight, ctx: NodeCtx):
    """Alg 4 — time-correlated sparse IA (global mask + Q_L local +
    incoming)."""
    m = ctx.global_mask                                   # line 3
    gt = _feedback(g, e, weight)                          # line 2
    m_k = _topq_mask_local(cfg, ctx, (1 - m) * gt, cfg.q_local)   # line 4
    m_in = torch.clamp(sp.support(gamma_in) - m, 0, 1)    # line 5
    mm = sp.mask_union(torch.broadcast_to(m, m_k.shape), m_k, m_in)  # line 6
    gbar = _masked(mm, gt) * _col(ctx.participate)
    e_new = gt - gbar                                     # line 7
    gamma_out = gamma_in + gbar                           # line 8
    return _finalize(cfg, g.shape[-1], gamma_out, e_new, m)


def step_cl_tc_sia(cfg, g, gamma_in, e, weight, ctx: NodeCtx):
    """Alg 5 — CL-SIA on the off-mask part; Γ is aggregated densely inside
    the global mask (cost ω·Q_G, no indices)."""
    p = _col(ctx.participate)
    m = ctx.global_mask                                   # line 3
    gt = _feedback(g, e, weight)                          # line 2
    s = torch.addcmul(gamma_in, p, gt)
    gamma_g = m * s                                       # line 4: Γ_k
    lam_tilde = (1 - m) * s                               # line 5: Λ̃_k
    lam = _topq_local(cfg, ctx, lam_tilde, cfg.q_local)   # line 5: Λ_k
    e_new = lam_tilde - lam                               # line 6
    gamma_out = gamma_g + lam
    gamma_out = torch.where(p > 0, gamma_out, gamma_in)
    e_new = torch.where(p > 0, e_new, gt)
    return _finalize(cfg, g.shape[-1], gamma_out, e_new, m)


def step_dense_ia(cfg, g, gamma_in, e, weight, ctx: NodeCtx):
    """IA without sparsification — the efficiency upper baseline (Fig 2b)."""
    d = g.shape[-1]
    p = _col(ctx.participate)
    gt = _feedback(g, e, weight)
    gamma_out = torch.addcmul(gamma_in, p, gt)
    e_new = torch.where(p > 0, torch.zeros_like(e), gt)
    lanes = g.shape[:-1]
    full = lambda v, dt: torch.full(lanes, v, dtype=dt, device=g.device)
    # dense transmission: d words, no index overhead
    stats = HopStats(nnz_out=full(d, torch.int32),
                     nnz_global=full(d, torch.int32),
                     nnz_local=full(0, torch.int32),
                     bits=full(float(cfg.omega * d), torch.float32),
                     err_sq=_lane_err_sq(e_new))
    return gamma_out, e_new, stats


NODE_STEPS = {
    AggKind.SIA: step_sia,
    AggKind.RE_SIA: step_re_sia,
    AggKind.CL_SIA: step_cl_sia,
    AggKind.TC_SIA: step_tc_sia,
    AggKind.CL_TC_SIA: step_cl_tc_sia,
    AggKind.DENSE_IA: step_dense_ia,
}


def _lanes_step(cfg: AggConfig):
    if cfg.kind == AggKind.ROUTING:
        raise ValueError(
            "ROUTING has no node step: it is a cost model (every client's "
            "sparse gradient is forwarded unmodified through all hops); use "
            "comm_cost.routing_sparse_bits, or run_chain with SIA for "
            "values.")
    return NODE_STEPS[cfg.kind]


def node_step(cfg: AggConfig):
    """The scalar node step for ``cfg.kind``:
    ``fn(cfg, g [d], gamma_in [d], e [d], weight, ctx) -> (gamma_out [d],
    e_new [d], HopStats of 0-d leaves)``. ``ctx.participate`` (and
    ``ctx.q_budget``) are scalars; the global mask is ``[d]``."""
    lanes = _lanes_step(cfg)

    def run(cfg, g, gamma_in, e, weight, ctx: NodeCtx):
        fused = _fused_scalar(cfg, g, gamma_in, e, weight, ctx)
        if fused is not None:
            return fused
        one = lambda x: torch.as_tensor(x, device=g.device).reshape(1)
        ctx1 = NodeCtx(global_mask=ctx.global_mask,
                       participate=one(ctx.participate),
                       q_budget=(None if ctx.q_budget is None
                                 else one(ctx.q_budget)))
        gout, e_new, stats = lanes(cfg, g[None], gamma_in[None], e[None],
                                   one(weight), ctx1)
        return gout[0], e_new[0], HopStats(*(s[0] for s in stats))

    return run


def level_step(cfg: AggConfig):
    """The whole-level node step for ``cfg.kind``::

        fn(g [W,d], gamma_in [W,d], e [W,d], weight [W], participate [W],
           global_mask ([d] shared or [W,d] per-lane), q_budget ([W]|None),
           valid ([W]|None)) -> (gamma_out [W,d], e_new [W,d], HopStats [W])

    One call runs all W slots of a padded level. On the fused path the
    level goes through the level kernels (:mod:`repro_torch.kernels.ops`);
    otherwise the unfused lane bodies run. Either way, lanes with
    ``valid == 0`` output zeros and count nothing.
    """
    lanes = _lanes_step(cfg)

    def run(g, gamma_in, e, weight, participate, global_mask,
            q_budget=None, valid=None):
        if fused_node_steps(cfg, weight, g, e, gamma_in):
            return _run_fused_level(cfg, g, gamma_in, e, weight,
                                    participate, global_mask, q_budget,
                                    valid)
        ctx = NodeCtx(global_mask=global_mask, participate=participate,
                      q_budget=q_budget)
        gamma_out, e_new, stats = lanes(cfg, g, gamma_in, e, weight, ctx)
        if valid is not None:
            ok = valid > 0
            gamma_out = torch.where(_col(ok), gamma_out,
                                    torch.zeros_like(gamma_out))
            e_new = torch.where(_col(ok), e_new, torch.zeros_like(e_new))
            stats = _mask_lanes(ok, stats)
        return gamma_out, e_new, stats

    return run


def level_step_batched(cfg: AggConfig):
    """The whole-level node step over B cohorts::

        fn(g [B,W,d], gamma_in [B,W,d], e [B,W,d], weight [B,W],
           participate [B,W],
           global_mask ([B,d] cohort-shared or [B,W,d] per-lane),
           q_budget ([B,W]|None), valid ([B,W]|None))
          -> (gamma_out [B,W,d], e_new [B,W,d], HopStats [B,W])

    The cohorts flatten cohort-major to ``B·W`` lanes (cohort b owns lanes
    ``b·W .. (b+1)·W − 1``) and run as one :func:`level_step`: on the
    fused path one launch per kernel stage for all cohorts, with the
    ``[B, d]`` masks passed compact (``gmask_cohorts=B``). The unfused
    path repeats them to ``[B·W, d]``. Every lane's math is its own row's,
    so each cohort gets what a :func:`level_step` of its own computes.
    """
    run1 = level_step(cfg)

    def run(g, gamma_in, e, weight, participate, global_mask,
            q_budget=None, valid=None):
        b, w, d = g.shape
        lanes = b * w

        def fl(x):
            return None if x is None else x.reshape((lanes,) + x.shape[2:])

        cohort_gm = global_mask.dim() == 2                  # [B, d]
        args = (fl(g), fl(gamma_in), fl(e), fl(weight), fl(participate))
        if cohort_gm and fused_node_steps(cfg, weight, g, e, gamma_in):
            gout, e_new, stats = _run_fused_level(
                cfg, *args, _f32(global_mask), fl(q_budget), fl(valid),
                cohorts=b)
        else:
            gm = (kref.expand_gmask(global_mask, lanes, b) if cohort_gm
                  else fl(global_mask))
            gout, e_new, stats = run1(*args, gm, fl(q_budget), fl(valid))

        def unfl(x):
            return x.reshape((b, w) + x.shape[1:])

        return unfl(gout), unfl(e_new), HopStats(*map(unfl, stats))

    return run
