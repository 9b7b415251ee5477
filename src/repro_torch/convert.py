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


def _tree(tree, dev):
    """A dict tree of numpy arrays → the same tree of tensors on ``dev``.
    bfloat16 leaves (``ml_dtypes.bfloat16``, which ``torch.as_tensor``
    cannot take) go through float32, which holds them exactly, and are
    cast back."""
    if isinstance(tree, Mapping):
        return {k: _tree(v, dev) for k, v in tree.items()}
    x = np.asarray(tree)
    if x.dtype.name == "bfloat16":
        return _t(x.astype(np.float32), dev).to(torch.bfloat16)
    return torch.as_tensor(np.array(x), device=dev)


def lm_params(tree: Mapping, device: DeviceLike = None) -> dict:
    """The reference's LM params tree (numpy leaves) → the port's tree
    (:func:`repro_torch.models.model.init_params`: same keys, stacked
    ``[L, …]`` leaves, same dtypes)."""
    return _tree(tree, resolve_device(device))


def placed_params(tree: Mapping, cfg, mesh):
    """The reference's LM params tree (numpy leaves) → the port's params
    placed on ``mesh`` as :func:`~repro_torch.train.step.init_state`
    places them: a :class:`~repro_torch.train.state.RankShards` (rank
    (k, m)'s shard of each leaf by ``param_pspecs``, the replicated leaves
    whole, on its device) on a mesh of several devices, the whole tree on
    the device of a mesh of one."""
    from repro_torch.models.partition import param_pspecs
    from repro_torch.train.step import shard_params

    if len(mesh.distinct()) == 1:
        return _tree(tree, mesh.devices[0])
    return shard_params(_tree(tree, torch.device("cpu")),
                        param_pspecs(cfg, mesh), mesh)


def lm_cache(tree: Mapping, device: DeviceLike = None) -> dict:
    """The reference's decode cache (numpy leaves) → the port's cache
    (:func:`repro_torch.models.model.init_cache`)."""
    return _tree(tree, resolve_device(device))


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


def train_state(state, device: DeviceLike = None):
    """A train state with ``step``, ``params``, ``master``, ``opt``
    (``step``/``m``/``v``), ``ef``, ``tcs_prev`` and ``stage_ef``
    attributes (numpy-convertible leaves, bfloat16 carried through
    float32) → :class:`~repro_torch.train.state.TrainState` on ``device``,
    leaf for leaf. Cohort-stacked states keep their leading axis
    (:func:`~repro_torch.train.step.place_state` places it on a mesh)."""
    from repro_torch.optim.optimizers import FlatOptState
    from repro_torch.train.state import TrainState

    dev = resolve_device(device)

    def leaf(x):
        return None if x is None else _tree(x, dev)

    opt = state.opt
    stage_ef = getattr(state, "stage_ef", None)
    return TrainState(
        step=torch.as_tensor(np.array(state.step), dtype=torch.int32,
                             device=dev),
        params=_tree(state.params, dev), master=leaf(state.master),
        opt=FlatOptState(step=torch.as_tensor(np.array(opt.step),
                                              dtype=torch.int32, device=dev),
                         m=leaf(opt.m), v=leaf(opt.v)),
        ef=leaf(state.ef),
        tcs_prev=None if state.tcs_prev is None else _tree(state.tcs_prev,
                                                           dev),
        stage_ef=None if stage_ef is None else tuple(leaf(e)
                                                     for e in stage_ef))
