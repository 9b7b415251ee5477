"""Aggregation semantics: sparsifiers, the five algorithms, the chain,
TCS masks, error feedback and the §V closed forms."""

# Every re-export resolves lazily (PEP 562). The reference imports its
# algorithm names eagerly, but here the kernels import this package
# (kernels → level → ref → core.sparsify) while the algorithms import the
# kernels (core.algorithms → kernels.ops), and the aggregator object API
# lives in repro_torch.agg, which builds on core.algorithms: only lazy
# names let `repro_torch.kernels`, `repro_torch.agg` and `repro_torch.core`
# bootstrap in any order.
_ALGORITHMS = ("AggConfig", "AggKind", "HopStats", "NodeCtx",
               "fused_node_steps", "level_step", "node_step")
_CHAIN = ("ChainResult", "run_chain", "run_chain_with_topology")
_AGG_API = ("AggState", "Aggregator", "ChainAggregator", "RoundOut",
            "flat_dim", "make_aggregator")

__all__ = [*_ALGORITHMS, *_CHAIN, *_AGG_API]


def __getattr__(name):
    if name in _ALGORITHMS:
        from repro_torch.core import algorithms as mod
    elif name in _CHAIN:
        from repro_torch.core import chain as mod
    elif name in _AGG_API:
        from repro_torch.core import api as mod
    else:
        raise AttributeError(
            f"module 'repro_torch.core' has no attribute {name!r}")
    return getattr(mod, name)
