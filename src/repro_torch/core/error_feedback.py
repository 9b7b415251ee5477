"""Error-feedback state for sparse aggregation (port of
:mod:`repro.core.error_feedback`).

Every node k keeps ``e_k`` — the mass it has not yet managed to transmit.
The algorithms start with ``g̃_k = D_k·g_k + e_k^{t-1}`` and bank whatever
was cut: ``e_k^t = (pre-sparsification) − (transmitted)``. The simulator
holds it as a ``[K, d]`` tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


class EFState(NamedTuple):
    """Error-feedback memory. ``e`` has shape [K, d] (sim) or [d]."""

    e: Tensor

    @property
    def dim(self) -> int:
        return self.e.shape[-1]


def init_ef(num_clients: int, dim: int, *, dtype=torch.float32,
            device: DeviceLike = None) -> EFState:
    """Zero EF rows for ``num_clients`` nodes, on ``cuda`` unless the
    caller names another device."""
    return EFState(e=torch.zeros((num_clients, dim), dtype=dtype,
                                 device=resolve_device(device)))


def init_ef_rank(dim: int, *, dtype=torch.float32,
                 device: DeviceLike = None) -> EFState:
    """A single node's EF state, on ``cuda`` unless asked otherwise."""
    return EFState(e=torch.zeros((dim,), dtype=dtype,
                                 device=resolve_device(device)))


def apply_feedback(g: Tensor, e: Tensor, weight) -> Tensor:
    """``g̃ = D_k·g + e`` (line 2 of every algorithm), one rounding."""
    return torch.addcmul(e, torch.as_tensor(weight, dtype=g.dtype,
                                            device=g.device), g)


def residual(pre: Tensor, sent: Tensor) -> Tensor:
    """``e' = pre − sent``: bank the untransmitted mass."""
    return pre - sent


def total_banked(ef: EFState) -> Tensor:
    """Diagnostic: total |mass| currently banked across clients."""
    return ef.e.abs().sum()


def rescale_clients(ef: EFState, keep: Tensor) -> EFState:
    """Zero the EF rows of departed clients (``keep``: bool [K])."""
    return EFState(e=torch.where(keep[:, None], ef.e,
                                 torch.zeros_like(ef.e)))
