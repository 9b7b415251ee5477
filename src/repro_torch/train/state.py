"""TrainState: everything that must survive a restart (checkpointed whole;
port of :mod:`repro.train.state`).

The aggregation state (per-client error feedback, TCS previous params) is
*training state*, exactly like optimizer moments — losing it silently
changes convergence (the paper's EF banks untransmitted gradient mass).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.optim.optimizers import FlatOptState, OptConfig

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Distributed-training configuration (aggregation + optimizer)."""

    agg: AggConfig = AggConfig(kind=AggKind.CL_SIA, q=1)
    opt: OptConfig = OptConfig()
    q_frac: float = 0.01            # global Q = q_frac · D_pad per round
    agg_dtype: str = "bfloat16"     # storage dtype of G / EF buffers
    ef_dtype: str = "bfloat16"
    lr_warmup: int = 100
    lr_decay_steps: int = 10_000
    # FSDP-style compute in the reference (the local batch sharded over
    # `model` too); the port's clients compute whole, so it changes
    # nothing here but is kept for configuration parity
    fsdp_compute: bool = False

    def needs_tcs(self) -> bool:
        return self.agg.kind in (AggKind.TC_SIA, AggKind.CL_TC_SIA)


class TrainState(NamedTuple):
    step: Tensor                    # int32 scalar
    params: Any                     # working tree (model dtype)
    master: Tensor                  # [D_pad] fp32, the flat master
    opt: FlatOptState               # flat, laid out like master
    ef: Tensor                      # [K_dp, D_pad] per-client error feedback
    tcs_prev: Optional[Any]         # params-shaped tree (TC algorithms)
    # upper-tier EF of a nested (staged) aggregation topology: one
    # [K_dp, D_pad // prod(K_0..K_{s-1})] array per stage ≥ 1 (rank
    # (dp, model) holds its stage-s EF slice) — None for flat topologies
    stage_ef: Optional[tuple] = None


def map_state(fn, tree: Any) -> Any:
    """``fn`` on every tensor of a state tree (NamedTuples, dicts, tuples;
    ``None`` stays ``None``), keeping its structure."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_state(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: map_state(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_state(fn, v) for v in tree)
    return fn(tree)


def abstract_like(tree: Any) -> Any:
    """The same tree with every tensor replaced by an empty ``meta``
    tensor of its shape and dtype (the reference's ShapeDtypeStruct)."""
    return map_state(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                           device="meta"), tree)


def state_to(tree: Any, device) -> Any:
    """The same tree with every tensor copied to ``device`` (the
    reference's ``jax.device_put`` of a whole state)."""
    return map_state(lambda x: x.to(device), tree)
