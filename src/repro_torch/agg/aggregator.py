"""Topology-polymorphic aggregator object (port of
:mod:`repro.agg.aggregator`).

:class:`Aggregator` wraps ``compile_plan``/``execute`` with the cross-round
state the five algorithms need (error feedback, TCS reference point) and
the flattening of structured gradients, so callers hand it stacked
per-client gradients in any shape over any topology — chain, permuted
chain, or routed tree — and get back the PS-side aggregate with exact §V
bit accounting.

Structured gradients are a dict, list or tuple (nested freely) of tensors
with a leading K axis. They flatten in the order of the reference's
``jax.flatten_util.ravel_pytree``: a dict's entries by **sorted key**,
sequences in order, each leaf row-major — so the flat rows, and the
aggregate unflattened from them, are the reference's.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.agg.plan import AggPlan, compile_plan, execute
from repro_torch.core import tcs as tcs_mod
from repro_torch.core.algorithms import AggConfig, AggKind, HopStats
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


class AggState(NamedTuple):
    """Cross-round aggregator state."""

    ef: Tensor                       # [K, d] error-feedback memory
    tcs_prev: Optional[Tensor]       # [d] w^{t-1} (TC algorithms) or None


class RoundOut(NamedTuple):
    aggregate: Any                   # structured (or flat) Σ_k D_k g_k estimate
    state: AggState
    stats: HopStats                  # per-hop, leaves [K]
    total_bits: Tensor               # Σ_k bits — scalar float32


def _needs_tcs(kind: AggKind) -> bool:
    return kind in (AggKind.TC_SIA, AggKind.CL_TC_SIA)


# ---------------------------------------------------------------------------
# Flattening in ravel_pytree's order
# ---------------------------------------------------------------------------

def _leaves(tree: Any) -> list:
    """Tensor leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    if tree is None:
        return []
    return [torch.as_tensor(tree)]


def _rebuild(tree: Any, leaves) -> Any:
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [_rebuild(t, leaves) for t in tree]
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    if tree is None:
        return None
    return next(leaves)


def ravel(tree: Any) -> tuple:
    """One structured value → (flat [d] tensor, unravel function)."""
    leaves = _leaves(tree)
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
    shapes = [(leaf.shape, leaf.dtype) for leaf in leaves]

    def unravel(vec: Tensor) -> Any:
        parts, at = [], 0
        for shape, dtype in shapes:
            n = shape.numel()
            parts.append(vec[at:at + n].reshape(shape).to(dtype))
            at += n
        return _rebuild(tree, iter(parts))

    return flat, unravel


def _as_flat_stack(grads: Any, num_clients: int,
                   dim: int) -> tuple[Tensor, Optional[Callable]]:
    """Accept a [K, d] tensor, or a structure whose leaves lead with K."""
    if isinstance(grads, Tensor) and grads.ndim == 2:
        if grads.shape != (num_clients, dim):
            raise ValueError(f"grads are {tuple(grads.shape)}, the "
                             f"aggregator takes ({num_clients}, {dim})")
        return grads, None
    leaves = _leaves(grads)
    if not leaves or any(leaf.ndim == 0 or leaf.shape[0] != num_clients
                         for leaf in leaves):
        raise ValueError(f"every leaf's leading dim must be K={num_clients}")
    flat = torch.cat([leaf.reshape(num_clients, -1) for leaf in leaves],
                     dim=1)
    if flat.shape != (num_clients, dim):
        raise ValueError(f"grads flatten to {tuple(flat.shape)}, the "
                         f"aggregator takes ({num_clients}, {dim})")
    one = _rebuild(grads, iter([leaf[0] for leaf in leaves]))
    return flat, ravel(one)[1]


def flat_dim(params: Any) -> int:
    """Total parameter count d of a structure (the paper's model dim)."""
    return int(sum(leaf.numel() for leaf in _leaves(params)))


# ---------------------------------------------------------------------------
# Aggregator
# ---------------------------------------------------------------------------

class Aggregator:
    """Multi-hop aggregator for K clients over a d-dim model, on any
    topology.

    ``topology`` accepts whatever ``compile_plan`` does — an ``AggTree``, a
    chain order, a ``ConstellationGraph``, a ``TreeTopology``, or nothing
    (the paper's identity chain). A precompiled ``plan`` takes precedence;
    ``round`` also takes a per-call ``plan`` so one Aggregator can follow a
    :class:`~repro_torch.agg.schedule.TopologySchedule`. The state lives on
    ``device`` (``cuda`` unless the caller asks for another); a round runs
    on the device of the gradients it is given.
    """

    def __init__(self, cfg: AggConfig, num_clients: int, dim: int, *,
                 topology: Any = None, plan: Optional[AggPlan] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.num_clients = num_clients
        self.dim = dim
        self.device = resolve_device(device)
        if plan is None:
            plan = compile_plan(
                num_clients if topology is None else topology,
                num_clients=num_clients)
        if plan.num_clients != num_clients:
            raise ValueError(f"plan is for {plan.num_clients} clients, "
                             f"aggregator for {num_clients}")
        self.plan = plan

    # -- state ------------------------------------------------------------
    def init_state(self, params: Any = None,
                   dtype: torch.dtype = torch.float32) -> AggState:
        ef = torch.zeros((self.num_clients, self.dim), dtype=dtype,
                         device=self.device)
        tcs_prev = None
        if _needs_tcs(self.cfg.kind):
            if params is None:
                tcs_prev = torch.zeros((self.dim,), dtype=dtype,
                                       device=self.device)
            else:
                tcs_prev = ravel(params)[0].to(dtype=dtype,
                                               device=self.device)
        return AggState(ef=ef, tcs_prev=tcs_prev)

    # -- one round ----------------------------------------------------------
    def round(
        self,
        grads: Any,                    # [K, d] tensor OR stacked structure
        state: AggState,
        weights: Tensor,               # [K] D_k
        *,
        params: Any = None,            # current params (TC algorithms)
        participate: Optional[Tensor] = None,
        plan: Optional[AggPlan] = None,
    ) -> RoundOut:
        flat, unravel = _as_flat_stack(grads, self.num_clients, self.dim)

        global_mask = None
        tcs_prev = state.tcs_prev
        if _needs_tcs(self.cfg.kind):
            if params is None:
                raise ValueError(f"{self.cfg.kind} needs current params for "
                                 "the TCS global mask")
            flat_params = ravel(params)[0].to(flat.dtype)
            # the configured Top-Q (exact or threshold), as the reference
            global_mask = tcs_mod.global_mask(
                tcs_mod.TCSState(tcs_prev), flat_params, self.cfg.q_global,
                topq_mask_fn=self.cfg.topq_mask_fn())
            tcs_prev = flat_params

        res = execute(self.cfg, self.plan if plan is None else plan,
                      flat, state.ef, weights,
                      global_mask=global_mask, participate=participate)
        agg = unravel(res.aggregate) if unravel is not None else res.aggregate
        return RoundOut(aggregate=agg,
                        state=AggState(ef=res.e_new, tcs_prev=tcs_prev),
                        stats=res.stats, total_bits=res.stats.bits.sum())
