"""Hierarchical (pod-aware) sparse incremental aggregation (port of
:mod:`repro.core.hierarchical`).

The flat ring treats (pod, data) as one chain, the paper's exact topology.
Links between pods are scarcer than links inside one, so the staged
schedule aggregates in two stages:

  stage 1: rotated ring over ``data`` inside each pod (K_d hops);
  stage 2: rotated ring over ``pod`` on the stage-1 partial aggregates
           (K_p hops, payload already CL-sparsified).

This is the chain×chain specialization of the nested-plan lowering: the
two-stage schedule is :func:`~repro_torch.agg.nested.pod_ring_nested` run
through :func:`repro_torch.agg.device.run_nested_segments_local`. Stage 2's
"gradient" is the pod-local partial aggregate (weight 1), with its own
error-feedback buffer (the pod-edge EF). Traffic between pods per round
drops from K_p·K_d segment payloads (the flat ring crosses the pod seam
every wrap-around) to K_p.

Semantics note: two-stage CL-SIA applies Top-Q twice (per pod, then
across pods), so it is not bit-identical to the flat chain; both are the
paper's algorithm on a two-level tree, and EF at both levels conserves the
mass.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core.algorithms import AggConfig
from repro_torch.core.ring import RingStats

Tensor = torch.Tensor


@functools.lru_cache(maxsize=None)
def _pod_ring_nested_cached(k_pod: int, k_data: int):
    from repro_torch.agg.nested import pod_ring_nested
    return pod_ring_nested(k_pod, k_data)


class HierStats(NamedTuple):
    intra: RingStats          # the data-axis (inside a pod) accounting
    inter: RingStats          # the pod-axis (between pods) accounting


def hierarchical_ring_local(
    cfg: AggConfig,
    mesh,
    flat: Sequence[Tensor],           # per rank: [n] gradient slice
    ef: Sequence[Tensor],             # per rank: [n] client-level EF
    pod_ef: Sequence[Tensor],         # per rank: [n // K_data] pod-edge EF
    weight,
    *,
    sizes: Sequence[int],             # (K_data, K_pod)
    global_mask: Optional[Sequence[Tensor]] = None,
    participate=None,
) -> tuple:
    """The two-stage ring over a mesh of ``K_data · K_pod`` ranks; rank
    ``p·K_data + r`` is member r of pod p.

    Returns per-rank lists ``(final segment [n / (K_d·K_p)], new client EF
    [n], new pod EF [n / K_d], HierStats)``. Rank (p, r) ends owning
    sub-segment p of segment r. The chain×chain nested plan through
    :func:`~repro_torch.agg.device.run_nested_segments_local`: stage 0 is
    the ring's chain over ``data``, stage 1 the ring's chain over ``pod``,
    both on the register path.
    """
    from repro_torch.agg.device import run_nested_segments_local

    k_data, k_pod = (int(s) for s in sizes)
    nested = _pod_ring_nested_cached(k_pod, k_data)
    seg2, ef_new, (pod_ef_new,), (st1, st2) = run_nested_segments_local(
        cfg, nested, mesh, flat, ef, (pod_ef,), weight,
        sizes=(k_data, k_pod), global_mask=global_mask,
        participate=participate)
    return seg2, ef_new, pod_ef_new, [HierStats(intra=a, inter=b)
                                      for a, b in zip(st1, st2)]


def dci_bytes_flat_vs_hier(k_pod: int, k_data: int, payload: int) -> tuple:
    """Analytic wire between pods per round: flat ring vs hierarchical.

    Flat ring over (pod, data): every one of the K_p·K_d hops crosses the
    pod seam at the pod boundaries, K_p·K_d payloads per round in all.
    Hierarchical: only stage 2 crosses, K_p payloads.
    """
    return k_pod * k_data * payload, k_pod * payload
