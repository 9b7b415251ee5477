"""Dispatching entries for the level kernels and the scalar ``[d]``
kernels.

Four modes, as in :mod:`repro.kernels.ops`:

* ``"auto"`` — the fused node-step path; CUDA tensors launch the
  hand-written kernels of :mod:`repro_torch.kernels.level`, CPU tensors run
  their plain versions (:mod:`repro_torch.kernels.ref`);
* ``"always"`` — the kernels and nothing else: a CPU tensor raises (there
  is no interpret mode for a CUDA kernel, and a caller who asked for the
  kernel must not get its plain version unawares);
* ``"never"`` — the unfused PyTorch node steps (the level entries below
  are not reached; a direct call runs the plain version);
* ``"ref"`` — the fused structure with the plain bodies on any device.

The choice follows the device of the tensors a call is given; a CUDA
tensor under ``"auto"`` or ``"always"`` launches the kernel or raises.

Which form a level takes is :func:`resident_level`, a rule on its shape
alone (the same on every device and in every mode): a lane that fits one
block's shared memory takes the resident forms (:func:`cl_fuse_select_level`
for exact CL Top-Q, :func:`ia_fuse_select_level` for every SIA, RE-SIA and
TC-SIA level with a static q, :func:`tau_search_fused_level` for the
threshold scan), one launch per level or search; a longer one the
multi-block kernels (``sparsify_ef_level`` then ``chain_accum_level`` for
the SIA family) and the torch ops around them.
"""

from __future__ import annotations

from typing import Literal

import torch

from repro_torch.kernels import level, ref
from repro_torch.kernels.chain_accum import chain_accum_cuda, cl_fuse_cuda
from repro_torch.kernels.sparsify_ef import sparsify_ef_cuda
from repro_torch.kernels.topq_threshold import (count_ge_cuda,
                                                count_ge_fused_cuda)

Mode = Literal["auto", "always", "never", "ref"]
MODES = ("auto", "always", "never", "ref")


def resolve(mode: Mode, device: torch.device) -> tuple[bool, bool]:
    """→ ``(fused, kernel)``: whether node steps take the fused level path,
    and whether its bodies are the CUDA kernels (CUDA tensors under
    ``"auto"``/``"always"``) rather than their plain versions. Raises for
    ``"always"`` on any device but CUDA."""
    if mode not in MODES:
        raise ValueError(f"unknown kernel_mode {mode!r} (expected one of "
                         f"{MODES})")
    if mode == "never":
        return False, False
    if mode == "ref":
        return True, False
    on_cuda = torch.device(device).type == "cuda"
    if mode == "always" and not on_cuda:
        raise RuntimeError(
            f"kernel_mode='always' runs the CUDA kernels only; got a tensor "
            f"on {device} (use 'auto' or 'ref' for the plain versions)")
    return True, on_cuda


def _kernel(mode: Mode, t: torch.Tensor) -> bool:
    return resolve(mode, t.device)[1]


# ---------------------------------------------------------------------------
# scalar [d] kernels: one row; weight, tau and participate a number or a
# one-element float32 tensor on the row's device
# ---------------------------------------------------------------------------

def count_ge(x, taus, *, mode: Mode = "auto"):
    """Candidate counts of one row: ``#{i : |x_i| >= taus_j}``, taus [B]
    f32 in any order → int32 [B]."""
    if _kernel(mode, x):
        return count_ge_cuda(x, taus)
    return ref.ref_count_ge(x, taus)


def sparsify_ef(g, e, mask_in, weight, tau, *, mode: Mode = "auto"):
    """Fused error feedback + sparsify of one row → (ḡ, e′, nnz)."""
    if _kernel(mode, g):
        return sparsify_ef_cuda(g, e, mask_in, weight, tau)
    return ref.ref_sparsify_ef(g, e, mask_in, weight, tau)


def chain_accum(gamma_in, gbar, *, mode: Mode = "auto"):
    """γ_out = γ_in + ḡ of one row → (γ_out, nnz)."""
    if _kernel(mode, gamma_in):
        return chain_accum_cuda(gamma_in, gbar)
    return ref.ref_chain_accum(gamma_in, gbar)


def cl_fuse(g, e, gamma_in, weight, tau, *, mode: Mode = "auto"):
    """The CL-SIA node step of one row given τ → (γ_out, e′, nnz)."""
    if _kernel(mode, g):
        return cl_fuse_cuda(g, e, gamma_in, weight, tau)
    return ref.ref_cl_fuse(g, e, gamma_in, weight, tau)


def count_ge_fused(g, e, gamma_in, weight, participate, taus, *,
                   include_gamma: bool = False, mode: Mode = "auto"):
    """Candidate counts of the 1-D operand ``w·g + e`` (``p·(w·g + e) +
    γ_in`` with ``include_gamma``) rebuilt from the raw node inputs;
    taus [B] → int32 [B]."""
    if _kernel(mode, g):
        return count_ge_fused_cuda(g, e, gamma_in, weight, participate, taus,
                                   include_gamma=include_gamma)
    return ref.ref_count_ge_fused(g, e, gamma_in, weight, participate, taus,
                                  include_gamma=include_gamma)


# ---------------------------------------------------------------------------
# level kernels: [W, d] lanes
# ---------------------------------------------------------------------------

def sparsify_ef_level(g, e, mask_in, weight, tau, valid, *,
                      with_err: bool = False, mode: Mode = "auto"):
    """Fused EF + sparsify over a level's W lanes ([W, d] inputs)."""
    if _kernel(mode, g):
        return level.sparsify_ef_level_cuda(g, e, mask_in, weight, tau,
                                            valid, with_err=with_err)
    return ref.ref_sparsify_ef_level(g, e, mask_in, weight, tau, valid,
                                     with_err=with_err)


def chain_accum_level(gamma_in, gbar, valid, gmask=None, *,
                      gmask_cohorts: int = 0, mode: Mode = "auto"):
    """IA combine with fused (total, off-global-mask) support counts;
    ``gmask`` lane-shared [d], per-lane [W, d] or, with
    ``gmask_cohorts=B``, cohort-shared [B, d] over cohort-major lanes."""
    if _kernel(mode, gamma_in):
        return level.chain_accum_level_cuda(gamma_in, gbar, valid, gmask,
                                            gmask_cohorts=gmask_cohorts)
    return ref.ref_chain_accum_level(gamma_in, gbar, valid, gmask,
                                     gmask_cohorts=gmask_cohorts)


def cl_fuse_level(g, e, gamma_in, weight, tau, participate, valid,
                  gmask=None, mask_in=None, *, gmask_cohorts: int = 0,
                  with_err: bool = False, mode: Mode = "auto"):
    """The complete CL node step (Algorithms 3/5, stragglers included)."""
    if _kernel(mode, g):
        return level.cl_fuse_level_cuda(g, e, gamma_in, weight, tau,
                                        participate, valid, gmask, mask_in,
                                        gmask_cohorts=gmask_cohorts,
                                        with_err=with_err)
    return ref.ref_cl_fuse_level(g, e, gamma_in, weight, tau, participate,
                                 valid, gmask, mask_in,
                                 gmask_cohorts=gmask_cohorts,
                                 with_err=with_err)


def count_ge_level(x, taus, *, mode: Mode = "auto"):
    """Per-lane candidate counts ([W, d] float32 or bfloat16 × [W, B]
    float32 → [W, B] int32)."""
    if _kernel(mode, x):
        return level.count_ge_level_cuda(x, taus)
    return ref.ref_count_ge_level(x, taus)


def count_ge_fused_level(g, e, gamma_in, weight, participate, taus,
                         gmask=None, *, include_gamma: bool = False,
                         gmask_cohorts: int = 0, mode: Mode = "auto"):
    """Per-lane candidate counts of the fused bisection operand
    ``(1−m)·(p·(w·g + e) + γ_in)``; [W, d] inputs, taus [W, B] → [W, B]."""
    if _kernel(mode, g):
        return level.count_ge_fused_level_cuda(
            g, e, gamma_in, weight, participate, taus, gmask,
            include_gamma=include_gamma, gmask_cohorts=gmask_cohorts)
    return ref.ref_count_ge_fused_level(g, e, gamma_in, weight, participate,
                                        taus, gmask,
                                        include_gamma=include_gamma,
                                        gmask_cohorts=gmask_cohorts)


def hist_topq_level(g, e, gamma_in, weight, participate, tables, gmask=None,
                    *, include_gamma: bool = False, gmask_cohorts: int = 0,
                    mode: Mode = "auto"):
    """Joint digit histogram of the fused operand (``tau_impl="hist"``);
    ``tables`` per :func:`repro_torch.core.sparsify._hist_tables` →
    ``(D2 [W, b+1, b+1], F [W, b+1])`` int32."""
    if _kernel(mode, g):
        return level.hist_topq_level_cuda(
            g, e, gamma_in, weight, participate, tables, gmask,
            include_gamma=include_gamma, gmask_cohorts=gmask_cohorts)
    return ref.ref_hist_topq_level(g, e, gamma_in, weight, participate,
                                   tables, gmask,
                                   include_gamma=include_gamma,
                                   gmask_cohorts=gmask_cohorts)


# ---------------------------------------------------------------------------
# resident forms: a whole level stage in one launch, for d ≤ RESIDENT_MAX_D
# ---------------------------------------------------------------------------

RESIDENT_MAX_D = level.RESIDENT_MAX_D
RESIDENT_MAX_BRANCH = level.RESIDENT_MAX_BRANCH


def resident_level(d: int, branch: int = 1) -> bool:
    """The dispatch rule between the two forms of a level's node step.

    A level whose lanes hold d ≤ :data:`RESIDENT_MAX_D` elements (the
    lane's keys fit one block's shared memory; the paper's d = 7850 among
    them) takes the resident node steps: exact CL Top-Q through
    :func:`cl_fuse_select_level`, and SIA, RE-SIA and TC-SIA, exact or
    given τ, through :func:`ia_fuse_select_level` (a per-lane ``q_budget``
    keeps the sort and the multi-block kernels). Its τ search, where its
    ``branch`` ≤ :data:`RESIDENT_MAX_BRANCH` candidates too, runs through
    :func:`tau_search_fused_level`. A longer lane takes the multi-block
    kernels (``cl_fuse_level`` after a sort; ``sparsify_ef_level`` then
    ``chain_accum_level``; ``count_ge_fused_level`` once per round), which
    reach 64–81 % of their bound at large d. The rule reads the shape
    only, so the CPU's plain versions take the same path.
    """
    return 1 <= d <= RESIDENT_MAX_D and 1 <= branch <= RESIDENT_MAX_BRANCH


def tau_search_fused_level(g, e, gamma_in, weight, participate, gmask=None,
                           *, q: int, branch: int, rounds: int,
                           include_gamma: bool = False,
                           gmask_cohorts: int = 0, mode: Mode = "auto"):
    """The whole threshold τ search (scan) of a level over the fused
    operand → ``(τ [W], counts [rounds, W, branch])``; d and branch within
    :func:`resident_level`."""
    if _kernel(mode, g):
        return level.tau_search_fused_level_cuda(
            g, e, gamma_in, weight, participate, gmask, q=q, branch=branch,
            rounds=rounds, include_gamma=include_gamma,
            gmask_cohorts=gmask_cohorts)
    return ref.ref_tau_search_fused_level(
        g, e, gamma_in, weight, participate, gmask, q=q, branch=branch,
        rounds=rounds, include_gamma=include_gamma,
        gmask_cohorts=gmask_cohorts)


def cl_fuse_select_level(g, e, gamma_in, weight, participate, valid,
                         gmask=None, *, q: int, gmask_cohorts: int = 0,
                         with_err: bool = False, mode: Mode = "auto"):
    """The exact CL node step of a level: exact Top-Q support of the CL
    operand and the CL fuse (Algorithms 3/5) → (γ_out, e′, nnz, nnz_off)
    (+ pinned ‖e′‖²); d within :func:`resident_level`."""
    if _kernel(mode, g):
        return level.cl_fuse_select_level_cuda(
            g, e, gamma_in, weight, participate, valid, gmask, q=q,
            gmask_cohorts=gmask_cohorts, with_err=with_err)
    return ref.ref_cl_fuse_select_level(
        g, e, gamma_in, weight, participate, valid, gmask, q=q,
        gmask_cohorts=gmask_cohorts, with_err=with_err)


def ia_fuse_select_level(g, e, gamma_in, weight, participate, valid,
                         gmask=None, *, kind, q=None, tau=None,
                         gmask_cohorts: int = 0, with_err: bool = False,
                         mode: Mode = "auto"):
    """The SIA, RE-SIA or TC-SIA node step of a level (``kind``): the
    local support (exact Top-Q of ``q``, or ``|x| ≥ τ`` for a given
    ``tau``), EF + sparsify and the IA combine → (γ_out, e′, nnz, nnz_off)
    (+ pinned ‖e′‖²); ``gmask`` for TC-SIA only; d within
    :func:`resident_level`."""
    if _kernel(mode, g):
        return level.ia_fuse_select_level_cuda(
            g, e, gamma_in, weight, participate, valid, gmask, kind=kind,
            q=q, tau=tau, gmask_cohorts=gmask_cohorts, with_err=with_err)
    return ref.ref_ia_fuse_select_level(
        g, e, gamma_in, weight, participate, valid, gmask, kind=kind, q=q,
        tau=tau, gmask_cohorts=gmask_cohorts, with_err=with_err)
