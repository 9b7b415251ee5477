"""Time-correlated sparsification (TCS) global mask (port of
:mod:`repro.core.tcs`).

``m^t = s(w^t − w^{t−1}, Q_G)`` is computed from the global model's own
motion, so every client holds the same mask. The state carried between
rounds is the previous flat parameter vector.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import sparsify as sp

Tensor = torch.Tensor


class TCSState(NamedTuple):
    prev_flat: Tensor   # w^{t-1}, flattened


def init_tcs(flat_params: Tensor) -> TCSState:
    """At t=0 there is no motion yet; m^0 is empty."""
    return TCSState(prev_flat=flat_params)


def global_mask(state: TCSState, flat_params: Tensor, q_global: int, *,
                topq_mask_fn=None) -> Tensor:
    """``m^t = s(w^t − w^{t−1}, Q_G)`` — 0/1 float mask of shape [d].

    With no motion (w^t == w^{t−1}, the first round) the mask is zero.
    """
    if topq_mask_fn is None:
        topq_mask_fn = sp.topq_mask
    delta = flat_params - state.prev_flat
    m = topq_mask_fn(delta, q_global)
    return torch.where((delta != 0).any(), m, torch.zeros_like(m))


def update(state: TCSState, flat_params: Tensor) -> TCSState:
    return TCSState(prev_flat=flat_params)
