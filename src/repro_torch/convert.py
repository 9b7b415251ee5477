"""Carry weights and state across from the JAX package.

Each function takes the reference's values as numpy arrays (or objects
whose named attributes convert to numpy arrays) and returns the port's
form. Nothing here imports the reference: the tests read its values out
with ``numpy.asarray`` and hand them over, so both packages compute on
identical inputs.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.agg.plan import AggPlan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fed.simulator import SimState


def _t(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def lr_params(params: Mapping, device: DeviceLike = None) -> dict:
    """``{"w": [784, 10], "b": [10]}`` logistic-regression parameters."""
    dev = resolve_device(device)
    return {"w": _t(params["w"], dev), "b": _t(params["b"], dev)}


def sim_state(state, device: DeviceLike = None) -> SimState:
    """A simulator state with ``round``, ``flat_w``, ``ef``, ``tcs_prev``
    and (optionally) ``stage_ef`` attributes →
    :class:`~repro_torch.fed.simulator.SimState` (the reference's random
    key has no counterpart: the port's minibatch draws come from a
    ``torch.Generator`` or are passed in)."""
    dev = resolve_device(device)
    return SimState(round=int(np.asarray(state.round)),
                    flat_w=_t(state.flat_w, dev), ef=_t(state.ef, dev),
                    tcs_prev=_t(state.tcs_prev, dev),
                    stage_ef=tuple(_t(e, dev)
                                   for e in getattr(state, "stage_ef", ())))


def agg_plan(plan) -> AggPlan:
    """An aggregation plan's arrays (``node_id``, ``slot_mask``,
    ``parent_row``, ``flat_pos``, ``alive``, optional ``q_budget``) and its
    ``num_clients``/``num_sinks`` → :class:`~repro_torch.agg.plan.AggPlan`.
    Plans stay numpy on the host."""
    qb = getattr(plan, "q_budget", None)
    return AggPlan(node_id=np.array(plan.node_id, np.int32),
                   slot_mask=np.array(plan.slot_mask, np.float32),
                   parent_row=np.array(plan.parent_row, np.int32),
                   flat_pos=np.array(plan.flat_pos, np.int32),
                   alive=np.array(plan.alive, np.float32),
                   q_budget=None if qb is None else np.array(qb, np.int32),
                   num_clients=int(plan.num_clients),
                   num_sinks=int(getattr(plan, "num_sinks", 1)))
