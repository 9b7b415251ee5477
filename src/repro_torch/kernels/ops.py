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
    """IA combine with fused (total, off-global-mask) support counts."""
    ref._no_cohorts(gmask_cohorts)
    if _kernel(mode, gamma_in):
        return level.chain_accum_level_cuda(gamma_in, gbar, valid, gmask)
    return ref.ref_chain_accum_level(gamma_in, gbar, valid, gmask)


def cl_fuse_level(g, e, gamma_in, weight, tau, participate, valid,
                  gmask=None, mask_in=None, *, gmask_cohorts: int = 0,
                  with_err: bool = False, mode: Mode = "auto"):
    """The complete CL node step (Algorithms 3/5, stragglers included)."""
    ref._no_cohorts(gmask_cohorts)
    if _kernel(mode, g):
        return level.cl_fuse_level_cuda(g, e, gamma_in, weight, tau,
                                        participate, valid, gmask, mask_in,
                                        with_err=with_err)
    return ref.ref_cl_fuse_level(g, e, gamma_in, weight, tau, participate,
                                 valid, gmask, mask_in, with_err=with_err)


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
    ref._no_cohorts(gmask_cohorts)
    if _kernel(mode, g):
        return level.count_ge_fused_level_cuda(
            g, e, gamma_in, weight, participate, taus, gmask,
            include_gamma=include_gamma)
    return ref.ref_count_ge_fused_level(g, e, gamma_in, weight, participate,
                                        taus, gmask,
                                        include_gamma=include_gamma)


def hist_topq_level(g, e, gamma_in, weight, participate, tables, gmask=None,
                    *, include_gamma: bool = False, gmask_cohorts: int = 0,
                    mode: Mode = "auto"):
    """Joint digit histogram of the fused operand (``tau_impl="hist"``);
    ``tables`` per :func:`repro_torch.core.sparsify._hist_tables` →
    ``(D2 [W, b+1, b+1], F [W, b+1])`` int32."""
    ref._no_cohorts(gmask_cohorts)
    if _kernel(mode, g):
        return level.hist_topq_level_cuda(
            g, e, gamma_in, weight, participate, tables, gmask,
            include_gamma=include_gamma)
    return ref.ref_hist_topq_level(g, e, gamma_in, weight, participate,
                                   tables, gmask,
                                   include_gamma=include_gamma)
