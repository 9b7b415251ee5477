"""Public API shims (port of :mod:`repro.core.api`): the aggregator object
lives in :mod:`repro_torch.agg`.

:class:`ChainAggregator` and :func:`make_aggregator` are deprecated thin
wrappers that pin the paper's identity chain, kept so old call sites keep
working.
"""

from __future__ import annotations

import warnings

from repro_torch.agg.aggregator import (AggState, Aggregator,  # noqa: F401
                                        RoundOut, flat_dim)
from repro_torch.core.algorithms import AggConfig
from repro_torch.device import DeviceLike


class ChainAggregator(Aggregator):
    """Deprecated: use :class:`repro_torch.agg.Aggregator` (chain is its
    default topology)."""

    def __init__(self, cfg: AggConfig, num_clients: int, dim: int, *,
                 device: DeviceLike = None):
        warnings.warn(
            "ChainAggregator is deprecated; use repro_torch.agg.Aggregator, "
            "which defaults to the chain topology and also takes "
            "trees/graphs", DeprecationWarning, stacklevel=2)
        super().__init__(cfg, num_clients, dim, device=device)


def make_aggregator(cfg: AggConfig, num_clients: int, dim: int, *,
                    device: DeviceLike = None) -> Aggregator:
    """Deprecated: construct :class:`repro_torch.agg.Aggregator`
    directly."""
    warnings.warn(
        "make_aggregator is deprecated; construct repro_torch.agg.Aggregator "
        "directly (pass topology=... for non-chain aggregation)",
        DeprecationWarning, stacklevel=2)
    return Aggregator(cfg, num_clients, dim, device=device)
