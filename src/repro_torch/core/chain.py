"""Sequential multi-hop chain aggregation — the paper's Fig. 1 semantics
(port of :mod:`repro.core.chain`).

Clients are indexed 1..K with client 1 adjacent to the PS; arrays are
indexed ``i = k-1`` (row 0 = client 1). The partial aggregate starts at
node K (γ_{K+1} = 0) and flows down the chain, one node step per hop; the
PS receives γ_1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.algorithms import (AggConfig, HopStats, NodeCtx,
                                         node_step)

Tensor = torch.Tensor


class ChainResult(NamedTuple):
    aggregate: Tensor     # γ_1 — what the PS receives, [d]
    e_new: Tensor         # updated EF memory, [K, d]
    stats: HopStats       # per-hop stats, leaves [K] (row i = client i+1)


def run_chain(
    cfg: AggConfig,
    grads: Tensor,                 # [K, d] per-client effective gradients
    e: Tensor,                     # [K, d] EF memory
    weights: Tensor,               # [K]    D_k
    *,
    global_mask: Optional[Tensor] = None,  # [d] TCS mask m^t
    participate: Optional[Tensor] = None,  # [K] 0/1 straggler mask
) -> ChainResult:
    """One aggregation round over the K-hop chain, on the device of
    ``grads``; hops run from the far end (client K) to client 1."""
    k, d = grads.shape
    dev, dt = grads.device, grads.dtype
    if global_mask is None:
        global_mask = torch.zeros((d,), dtype=dt, device=dev)
    if participate is None:
        participate = torch.ones((k,), dtype=dt, device=dev)
    step = node_step(cfg)
    gamma = torch.zeros((d,), dtype=dt, device=dev)
    e_rows, hop_stats = [None] * k, [None] * k
    for i in reversed(range(k)):
        ctx = NodeCtx(global_mask=global_mask, participate=participate[i])
        gamma, e_rows[i], hop_stats[i] = step(cfg, grads[i], gamma, e[i],
                                              weights[i], ctx)
    stats = HopStats(*(torch.stack(leaf) for leaf in zip(*hop_stats)))
    return ChainResult(aggregate=gamma, e_new=torch.stack(e_rows),
                       stats=stats)


def run_chain_with_topology(
    cfg: AggConfig,
    grads: Tensor,
    e: Tensor,
    weights: Tensor,
    order,                         # [K] int — the clients' visiting order
    *,
    global_mask: Optional[Tensor] = None,
    participate: Optional[Tensor] = None,
) -> ChainResult:
    """Chain aggregation over an arbitrary (healed) node ordering.

    Client ``order[j]`` takes chain row j: ``order[0]`` is the client next
    to the PS and ``order[-1]`` the far end, where the hops start. This is
    the reference's code (its docstring's "farthest first" describes the
    walk, not the index), and the same order ``compile_plan`` takes, so
    ``execute(compile_plan(order))`` gives the same bits. EF rows and stats
    come back in *client* index order.
    """
    k = grads.shape[0]
    perm = torch.as_tensor(order, dtype=torch.int64, device=grads.device)
    if perm.shape != (k,):
        raise ValueError(f"order must be [K={k}]; got {tuple(perm.shape)}")
    inv = torch.argsort(perm)
    res = run_chain(cfg, grads[perm], e[perm], weights[perm],
                    global_mask=global_mask,
                    participate=None if participate is None
                    else participate[perm])
    stats = HopStats(*(s[inv] if s.ndim >= 1 and s.shape[0] == k else s
                       for s in res.stats))
    return ChainResult(aggregate=res.aggregate, e_new=res.e_new[inv],
                       stats=stats)
