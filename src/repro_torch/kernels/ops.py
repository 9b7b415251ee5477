"""Dispatching entries for the level kernels.

Four modes, as in :mod:`repro.kernels.ops`:

* ``"auto"`` / ``"always"`` — the fused node-step path; CUDA tensors launch
  the hand-written kernels of :mod:`repro_torch.kernels.level`, CPU tensors
  run their plain versions (:mod:`repro_torch.kernels.ref`);
* ``"never"`` — the unfused PyTorch node steps (the entries below are not
  reached);
* ``"ref"`` — the fused structure with the plain bodies on any device.

The choice follows the device of the tensors a call is given; a CUDA
tensor under ``"auto"`` or ``"always"`` launches the kernel or raises.
"""

from __future__ import annotations

from typing import Literal

import torch

from repro_torch.kernels import level, ref

Mode = Literal["auto", "always", "never", "ref"]
MODES = ("auto", "always", "never", "ref")


def resolve(mode: Mode, device: torch.device) -> tuple[bool, bool]:
    """→ ``(fused, kernel)``: whether node steps take the fused level path,
    and whether its bodies are the CUDA kernels (CUDA tensors under
    ``"auto"``/``"always"``) rather than their plain versions."""
    if mode not in MODES:
        raise ValueError(f"unknown kernel_mode {mode!r} (expected one of "
                         f"{MODES})")
    if mode == "never":
        return False, False
    if mode == "ref":
        return True, False
    return True, torch.device(device).type == "cuda"


def _kernel(mode: Mode, t: torch.Tensor) -> bool:
    return resolve(mode, t.device)[1]


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
