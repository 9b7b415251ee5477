"""Elastic scaling: change the client count K between rounds (port of
:mod:`repro.runtime.elastic`).

State transformations for grow/shrink — EF rows are per-client, so scaling
is a row-level operation; the flat master/optimizer are K-independent.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def resize_ef(ef: Tensor, new_k: int, *, redistribute: bool = True
              ) -> Tensor:
    """``[K, D]`` → ``[new_K, D]``.

    Shrink: surviving rows keep their memory; departing rows' banked mass
    is redistributed equally to survivors (``redistribute=True``, keeps
    the total un-transmitted mass conserved) or dropped (False —
    bounded-loss mode, matches a crash). Grow: new clients start with zero
    memory.
    """
    k, d = ef.shape
    if new_k == k:
        return ef
    if new_k > k:
        pad = torch.zeros((new_k - k, d), dtype=ef.dtype, device=ef.device)
        return torch.cat([ef, pad], dim=0)
    kept = ef[:new_k]
    if redistribute:
        lost = torch.sum(ef[new_k:], dim=0, keepdim=True)
        kept = kept + lost / new_k
    return kept


def rebalance_weights(num_clients: int, sample_counts=None,
                      device=None) -> Tensor:
    """D_k weights after a membership change (uniform unless counts are
    given); float32 on ``device`` (the counts' device, else the CPU)."""
    if sample_counts is None:
        return torch.full((num_clients,), 1.0 / num_clients,
                          dtype=torch.float32, device=device)
    c = torch.as_tensor(sample_counts, dtype=torch.float32, device=device)
    return c / torch.sum(c)
