"""Plain PyTorch versions of the level kernels (the port of
:mod:`repro.kernels.ref`'s level part).

Each ``ref_*`` function is the contract its CUDA kernel in
:mod:`repro_torch.kernels.level` meets bit for bit. They are what the
kernel wrappers run for CPU tensors, and what the tests hold against the
JAX package.

Rounding follows the jitted JAX reference exactly. XLA contracts every
``a*b + c`` of these bodies into one fused multiply-add, so each such site
is written as :func:`torch.addcmul` (one rounding), never as eager
``a*b + c`` (two roundings). The sites are ``w·g + e``, ``p·g̃ + γ_in``
and ``m·s + Λ``; the pinned ‖e′‖² fold contracts its first level too.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

SUBLANES = 8
LANES = 1024
BLOCK = SUBLANES * LANES


def _no_cohorts(gmask_cohorts: int):
    if gmask_cohorts:
        raise NotImplementedError(
            "cohort-shared [B, d] global masks (gmask_cohorts) are not "
            "ported yet — ROADMAP A10")


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
    """γ_out = γ_in + ḡ with the total and off-global-mask support counts.

    ``gmask`` is lane-shared ``[d]`` or per-lane ``[W, d]``; without it
    ``nnz_off == nnz``. Returns (γ_out, nnz [W] i32, nnz_off [W] i32).
    """
    _no_cohorts(gmask_cohorts)
    gamma = gamma_in.to(torch.float32) + gbar.to(torch.float32)
    gamma = _apply_valid(valid, gamma)
    nz = gamma != 0
    nnz = nz.sum(dim=-1, dtype=torch.int32)
    return (gamma.to(gamma_in.dtype), nnz,
            _off_mask_count(nz, gmask, nnz))


def ref_cl_fuse_level(g, e, gamma_in, weight, tau, participate, valid,
                      gmask=None, mask_in=None, *, gmask_cohorts: int = 0,
                      with_err: bool = False):
    """The complete CL node step (Algorithms 3/5 with stragglers).

    g̃ = w·g + e; s = p·g̃ + γ_in; Λ̃ = (1−m)·s; keep = |Λ̃| ≥ τ ∨ mask_in;
    Λ = keep ? Λ̃ : 0; e′ = Λ̃ − Λ; γ = m·s + Λ (Alg 3: γ = Λ); a lane with
    p = 0 forwards (γ_in, g̃). Returns (γ_out, e′, nnz [W] i32,
    nnz_off [W] i32), plus the pinned-order ‖e′‖² when ``with_err``.
    """
    _no_cohorts(gmask_cohorts)
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
    computed from it select what the kernels' τ test would.
    """
    _no_cohorts(gmask_cohorts)
    s = torch.addcmul(e.to(torch.float32), weight[:, None].to(torch.float32),
                      g.to(torch.float32))
    if include_gamma:
        s = torch.addcmul(gamma_in.to(torch.float32),
                          participate[:, None].to(torch.float32), s)
    if gmask is not None:
        s = (1.0 - gmask) * s
    return s
