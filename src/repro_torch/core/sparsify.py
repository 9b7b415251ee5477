"""Exact Top-Q sparsification primitives (the port of
:mod:`repro.core.sparsify`'s exact part).

Notation follows the paper: ``S(x, Q)`` keeps the Top-Q (by magnitude)
entries of ``x`` and zeroes the rest; ``s(x, Q)`` is the matching 0/1 mask.
Every function works on the last axis, so a ``[W, d]`` level of lanes is
sparsified row by row in one call.

Ties keep the lower index first, as ``jax.lax.top_k`` does: the support is
read off a *stable* descending sort of ``|x|``. ``torch.topk`` breaks ties
differently and is not used.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _topq_index(x: Tensor, q: int) -> Tensor:
    """Indices of the q largest ``|x|`` per row, lower index first on ties."""
    order = torch.sort(x.abs(), dim=-1, descending=True, stable=True).indices
    return order[..., :q]


def topq(x: Tensor, q: int) -> Tensor:
    """``S(x, Q)``: keep the Q largest-magnitude entries of ``x``."""
    if q <= 0:
        return torch.zeros_like(x)
    if q >= x.shape[-1]:
        return x
    keep = torch.zeros_like(x, dtype=torch.bool).scatter_(
        -1, _topq_index(x, q), True)
    return torch.where(keep, x, torch.zeros_like(x))


def topq_mask(x: Tensor, q: int) -> Tensor:
    """``s(x, Q)``: the 0/1 float mask of the Top-Q support of ``x``."""
    if q <= 0:
        return torch.zeros_like(x)
    if q >= x.shape[-1]:
        return torch.ones_like(x)
    return torch.zeros_like(x).scatter_(-1, _topq_index(x, q), 1.0)


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
