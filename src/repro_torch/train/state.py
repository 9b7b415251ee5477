"""TrainState: everything that must survive a restart (checkpointed whole;
port of :mod:`repro.train.state`).

The aggregation state (per-client error feedback, TCS previous params) is
*training state*, exactly like optimizer moments — losing it silently
changes convergence (the paper's EF banks untransmitted gradient mass).

On a mesh of several devices a state's leaves are placed by rank
(:func:`repro_torch.train.step.init_state`): a flat leaf is a
:class:`RankPieces` (one piece per rank, on that rank's device) and the
params and ``tcs_prev`` a :class:`RankShards` (rank (k, m)'s tree: its
shard of each model-sharded leaf by ``param_pspecs``, the replicated leaves
whole, on its device). :func:`map_state`, :func:`abstract_like` and
:func:`state_to` keep that structure; :func:`gather_state` gives the
reference's global layout, whole tensors on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.device import to_device
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
    # FSDP-style compute: each client's batch split over `model` (its
    # ranks gather the model-sharded params whole), as the reference's
    # ssm/hybrid archs always run (train.step, phase 1)
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


class RankPieces:
    """A flat leaf placed by rank: ``pieces[r]`` is rank r's piece on that
    rank's device (r = k·M + m for DP rank k and model column m), and
    ``index[r]`` where it sits in the global leaf — ``(slice,)`` along the
    last axis (master, moments, aggregate) or ``(row, slice)`` (EF, stage
    EF). ``tail`` is the global leaf's shape past the axes every piece
    keeps whole (a cohort axis leads each piece)."""

    __slots__ = ("pieces", "index", "tail")

    def __init__(self, pieces, index, tail):
        self.pieces, self.index, self.tail = (tuple(pieces), tuple(index),
                                              tuple(tail))

    def map(self, fn) -> "RankPieces":
        return RankPieces([fn(p) for p in self.pieces], self.index,
                          self.tail)

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    @property
    def shape(self) -> tuple:
        """The global leaf's shape."""
        return tuple(self.pieces[0].shape[:-1]) + self.tail

    def gather(self, device) -> Tensor:
        """The global leaf on ``device``."""
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for p, ix in zip(self.pieces, self.index):
            out[(Ellipsis,) + ix] = to_device(p, out.device)
        return out


class RankShards:
    """A param tree placed by rank: rank (k, m) holds column m's tree —
    shard m of each model-sharded leaf (by ``param_pspecs``), the
    replicated leaves whole — on its device. Ranks that share a device and
    a column share one tree: ``trees[i]`` is column ``cols[i]``'s tree on
    ``devices[i]``. ``dims[j]`` is the model dimension of leaf j (in
    ``tree_leaves`` order; ``None`` for a replicated leaf)."""

    __slots__ = ("devices", "cols", "trees", "dims")

    def __init__(self, devices, cols, trees, dims):
        self.devices = tuple(torch.device(d) for d in devices)
        self.cols, self.trees, self.dims = (tuple(cols), tuple(trees),
                                            tuple(dims))

    def on(self, device, m: int) -> Any:
        """Column m's tree on ``device``."""
        key = (torch.device(device), m)
        for dev, col, tree in zip(self.devices, self.cols, self.trees):
            if (dev, col) == key:
                return tree
        raise KeyError(f"no column-{m} tree on {device}")

    def column(self, m: int) -> Any:
        """Column m's first tree."""
        return self.trees[self.cols.index(m)]

    def map(self, fn) -> "RankShards":
        return RankShards(self.devices, self.cols,
                          [map_state(fn, t) for t in self.trees], self.dims)

    def gather(self, device) -> Any:
        """The whole tree on ``device`` (each sharded leaf's columns
        concatenated along its model dimension)."""
        from repro_torch.core.flat_layout import (tree_structure,
                                                  tree_unflatten)
        from repro_torch.models.transformer import tree_leaves
        dev = torch.device(device)
        cols = [tree_leaves(self.column(m))
                for m in range(max(self.cols) + 1)]
        out = [to_device(cols[0][j], dev) if dim is None else
               torch.cat([to_device(c[j], dev) for c in cols], dim)
               for j, dim in enumerate(self.dims)]
        return tree_unflatten(tree_structure(self.trees[0]), out)


class RankCache:
    """A decode cache placed by rank (:mod:`repro_torch.models.
    serve_split`): rank r's block of each leaf by ``cache_pspecs``, on its
    device. ``split`` is the ``ServeSplit`` that placed it; ranks that
    share a device and a block share one tree, and ``trees[split.index[r]]``
    is rank r's (the whole cache's keys, each leaf its block, padded as
    XLA pads)."""

    __slots__ = ("trees", "split")

    def __init__(self, trees, split):
        self.trees, self.split = tuple(trees), split

    def rank(self, r: int) -> Any:
        """Rank r's tree."""
        return self.trees[self.split.index[r]]

    def map(self, fn) -> "RankCache":
        return RankCache([map_state(fn, t) for t in self.trees], self.split)


def map_state(fn, tree: Any) -> Any:
    """``fn`` on every tensor of a state tree (NamedTuples, dicts, tuples,
    :class:`RankPieces` and :class:`RankShards`; ``None`` stays ``None``),
    keeping its structure."""
    if tree is None:
        return None
    if isinstance(tree, (RankPieces, RankShards, RankCache)):
        return tree.map(fn)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_state(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: map_state(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_state(fn, v) for v in tree)
    return fn(tree)


def state_leaves(tree: Any) -> list:
    """Every tensor of a state tree, each piece and replica included."""
    out: list = []
    map_state(out.append, tree)
    return out


def abstract_like(tree: Any) -> Any:
    """The same tree with every tensor replaced by an empty ``meta``
    tensor of its shape and dtype (the reference's ShapeDtypeStruct)."""
    return map_state(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                           device="meta"), tree)


def state_to(tree: Any, device) -> Any:
    """The same tree with every tensor copied to ``device`` (the
    reference's ``jax.device_put`` of a whole state; a placed state keeps
    its pieces, all on ``device``)."""
    return map_state(lambda x: x.to(device), tree)


def gather_state(tree: Any, device) -> Any:
    """A placed state in the reference's global layout: each
    :class:`RankPieces` and :class:`RankShards` gathered whole, every
    tensor on ``device``."""
    if tree is None:
        return None
    if isinstance(tree, (RankPieces, RankShards)):
        return tree.gather(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(gather_state(v, device) for v in tree))
    if isinstance(tree, dict):
        return {k: gather_state(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(gather_state(v, device) for v in tree)
    return to_device(tree, torch.device(device))
