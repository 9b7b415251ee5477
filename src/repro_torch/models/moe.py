"""Mixture-of-Experts FFN: grouped GShard-style one-hot einsum dispatch.

The reference's formulation: tokens are split into groups of
``group_size``; each group routes into per-group capacity buffers through
one-hot dispatch tensors, with token-dropping capacity semantics per group
(priority = slot order, k-major within token, tokens in order). Aux
load-balancing loss = E·Σ f_e·p_e over the pre-drop assignment.

Top-k is a stable descending sort, as ``jax.lax.top_k`` breaks ties by
index; a dropped assignment's one-hot row is all zeros.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

GROUP_SIZE = 1024


def moe_capacity(group: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    cap = int(group * top_k * capacity_factor / num_experts)
    return max(4, (cap + 3) // 4 * 4)


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def expert_ffn(params, hin: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over their capacity buffers, ``hin [E, n, D]``
    → ``[E, n, D]`` (a ``d_ff`` shard of the weights gives its partial
    sum)."""
    gate = F.silu(torch.einsum("ecd,edf->ecf", hin, params["w_gate"]))
    up = torch.einsum("ecd,edf->ecf", hin, params["w_up"])
    return torch.einsum("ecf,efd->ecd", gate * up, params["w_down"])


def moe_ffn(params, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float, group_size: int = GROUP_SIZE,
            experts=None, with_fracs: bool = False):
    """x: [B, S, D] → (y [B, S, D], aux_loss scalar).

    params: router [D, E]; w_gate, w_up [E, D, F]; w_down [E, F, D].
    ``experts`` (``hin [E, n, D]`` → ``[E, n, D]``) replaces
    :func:`expert_ffn` on ``params`` (the tensor-parallel experts of
    :mod:`repro_torch.models.tp`: the routing runs here, once).
    ``with_fracs`` adds a third output, ``[frac_tokens, frac_probs]``
    (``[2, E]`` f32, the means the aux is the product of), for a client
    whose batch runs in pieces: the aux of the whole batch is
    :func:`aux_of` of the pieces' mean fractions.
    """
    b, s, d = x.shape
    t = b * s
    e = num_experts
    g = min(group_size, t)
    ng = t // g
    assert t % g == 0, (t, g)
    xg = x.reshape(ng, g, d)

    router = params["router"]
    rdt = torch.promote_types(xg.dtype, router.dtype)
    logits = torch.einsum("ngd,de->nge", xg.to(rdt),
                          router.to(rdt)).float()
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = srt[..., :top_k], idx[..., :top_k]       # [ng, g, k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # aux load-balance loss (Switch/Mixtral), over the pre-drop assignment
    assign = _one_hot(topi, e, torch.float32)             # [ng, g, k, E]
    frac_tokens = assign.sum(2).mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = aux_of(frac_tokens, frac_probs, e)

    cap = moe_capacity(g, e, top_k, capacity_factor)

    # position of each assignment inside its (group, expert) buffer:
    # priority = slot order (k-major within token, tokens in order)
    flat_assign = assign.reshape(ng, g * top_k, e)        # [ng, gk, E]
    pos = torch.cumsum(flat_assign, dim=1) - flat_assign  # exclusive prefix
    pos = torch.sum(pos * flat_assign, dim=-1)            # [ng, gk]
    keep = (pos < cap) & (flat_assign.sum(-1) > 0)
    slot = torch.where(keep, pos, float(cap)).long()
    pos_oh = _one_hot(slot, cap, xg.dtype)                # [ng, gk, cap]
    disp = (flat_assign.to(xg.dtype)[..., None]
            * pos_oh[..., None, :])                       # [ng, gk, E, cap]

    # dispatch: [ng, gk, E, cap] × [ng, g(k-repeated), D] → [ng, E, cap, D]
    x_rep = torch.repeat_interleave(xg, top_k, dim=1)     # [ng, gk, D]
    buf = torch.einsum("ntec,ntd->necd", disp, x_rep)

    # expert SwiGLU over [E, ng·cap, D]
    hin = buf.movedim(1, 0).reshape(e, ng * cap, d)
    hout = (expert_ffn(params, hin) if experts is None else experts(hin))
    hout = hout.reshape(e, ng, cap, d).movedim(0, 1)      # [ng, E, cap, D]

    # combine with router weights on kept slots
    w = (topv.reshape(ng, g * top_k) * keep).to(hout.dtype)
    y = torch.einsum("ntec,nt,necd->ntd", disp, w, hout)  # [ng, gk, D]
    y = y.reshape(ng, g, top_k, d).sum(dim=2)
    y = y.reshape(b, s, d).to(x.dtype)
    if with_fracs:
        return y, aux, torch.stack([frac_tokens, frac_probs])
    return y, aux


def aux_of(frac_tokens: torch.Tensor, frac_probs: torch.Tensor,
           num_experts: int) -> torch.Tensor:
    """The load-balancing loss ``E · Σ_e f_e · p_e`` of the fractions."""
    return num_experts * torch.sum(frac_tokens * frac_probs)
