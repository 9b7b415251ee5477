"""Shard-aligned flat parameter space (port of
:mod:`repro.core.flat_layout`).

The flat space is defined per model column::

  global flat vector := concat over model columns m of
      concat over leaves of (leaf's column-m piece, padded)

* model-sharded leaves: the column-m piece is the leaf's own shard along
  its model dim (its TP shard in the reference);
* model-replicated leaves (non-divisible heads, mamba in_proj, norms):
  column m takes the m-th slice of the leaf's (padded) ravel.

All flat-space state (master, optimizer moments, EF, TCS masks, ring
segments) uses this one layout. The layout is mesh-dependent.

The reference flattens inside a manual ``shard_map`` where a sharded leaf
arrives as its shard; the port has one controller, so
:meth:`FlatLayout.local_flatten` takes either the shard or the whole leaf
(it slices a whole one), and :meth:`FlatLayout.local_unflatten` takes all
``M`` columns, from which a replicated leaf is reassembled (the
reference's ``all_gather`` over ``model``). Leaf order is
``jax.tree.leaves`` order: sorted dict keys
(:func:`repro_torch.models.transformer.tree_leaves`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.device import to_device
from repro_torch.models.transformer import tree_leaves

Tensor = torch.Tensor


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n


def tree_structure(tree) -> Any:
    """The dict skeleton of a tree (leaves replaced by ``None``)."""
    if isinstance(tree, dict):
        return {k: tree_structure(v) for k, v in tree.items()}
    return None


def tree_unflatten(structure, leaves: Sequence) -> Any:
    """Inverse of :func:`tree_leaves` over a :func:`tree_structure`."""
    it = iter(leaves)

    def build(s):
        if isinstance(s, dict):
            return {k: build(s[k]) for k in sorted(s)}
        return next(it)

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    global_shape: tuple
    local_shape: tuple          # shape of the per-column shard
    model_dim: Optional[int]    # which dim is model-sharded (None = repl.)
    local_size: int             # flat length this leaf contributes per column
    pad: int                    # zeros appended to the raveled piece
    dtype: Any


class FlatLayout:
    """Layout plan for one (param template, param specs, mesh) triple."""

    def __init__(self, template: Any, specs: Any, mesh):
        self.mesh = mesh
        self.m = mesh.shape.get("model", 1)
        dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        self.k_dp = _prod(mesh.shape[a] for a in dp) if dp else 1
        self.treedef = tree_structure(template)
        t_leaves = tree_leaves(template)
        s_leaves = tree_leaves(specs)
        assert len(t_leaves) == len(s_leaves), "template/specs mismatch"
        plans = []
        for leaf, spec in zip(t_leaves, s_leaves):
            shape = tuple(int(d) for d in leaf.shape)
            model_dim = None
            for i, ax in enumerate(spec):
                names = ax if isinstance(ax, tuple) else (ax,)
                if "model" in names:
                    model_dim = i
            if model_dim is not None and shape[model_dim] % self.m == 0:
                local_shape = list(shape)
                local_shape[model_dim] //= self.m
                local_size = _prod(local_shape)
                pad = 0
            else:
                model_dim = None
                local_shape = list(shape)
                full = _prod(shape)
                padded = -(-full // self.m) * self.m
                local_size = padded // self.m
                pad = padded - full
            plans.append(LeafPlan(shape, tuple(local_shape), model_dim,
                                  local_size, pad, leaf.dtype))
        self.plans: Sequence[LeafPlan] = tuple(plans)
        raw = sum(p.local_size for p in plans)
        # ring needs n_local % k_dp == 0; pad the column tail
        self.n_local = -(-raw // max(self.k_dp, 1)) * max(self.k_dp, 1)
        self.tail_pad = self.n_local - raw
        self.d_flat = self.n_local * self.m        # global flat length

    # ------------------------------------------------------------------
    # Per-column transforms
    # ------------------------------------------------------------------

    def piece(self, plan: LeafPlan, leaf: Tensor, m_idx: int,
              dtype) -> Tensor:
        """One leaf's column ``m_idx`` piece, raveled, in ``dtype``."""
        if plan.model_dim is None:
            flat = leaf.reshape(-1).to(dtype)
            if plan.pad:
                flat = F.pad(flat, (0, plan.pad))
            return flat[m_idx * plan.local_size:
                        (m_idx + 1) * plan.local_size]
        if tuple(leaf.shape) != plan.local_shape:        # the whole leaf
            width = plan.local_shape[plan.model_dim]
            leaf = leaf.narrow(plan.model_dim, m_idx * width, width)
        return leaf.reshape(-1).to(dtype)

    def local_flatten(self, leaves_local: Sequence[Tensor], m_idx: int,
                      dtype=torch.float32, device=None) -> Tensor:
        """Leaves → column ``m_idx``'s ``[n_local]`` flat piece (on
        ``device``, each leaf's piece moved there, or on the leaves' own).

        A model-sharded leaf may arrive as its column shard (the
        reference's view inside ``shard_map``) or whole (it is sliced);
        replicated leaves arrive whole.
        """
        parts = [self.piece(plan, leaf, int(m_idx), dtype)
                 for plan, leaf in zip(self.plans, leaves_local)]
        if device is not None:
            parts = [to_device(p, torch.device(device)) for p in parts]
        return self.join(parts, dtype)

    def join(self, parts: Sequence[Tensor], dtype=torch.float32) -> Tensor:
        """Each leaf's column piece, in leaf order → the ``[n_local]``
        column (the tail padded with zeros)."""
        if not parts:
            return torch.zeros((self.n_local,), dtype=dtype)
        col = torch.cat(list(parts))
        if self.tail_pad:
            col = F.pad(col, (0, self.tail_pad))
        return col

    def flatten(self, leaves: Sequence[Tensor], dtype=torch.float32
                ) -> Tensor:
        """Whole leaves → the global ``[d_flat]`` vector (columns in
        order)."""
        return torch.cat([self.local_flatten(leaves, m, dtype)
                          for m in range(self.m)])

    def _columns(self, cols: Tensor) -> Tensor:
        return cols.reshape(self.m, self.n_local)

    def local_unflatten(self, cols: Tensor, m_idx: int) -> list:
        """All ``M`` columns (``[M, n_local]`` or the global ``[d_flat]``)
        → column ``m_idx``'s leaves: model-sharded leaves as the column's
        shard, replicated leaves whole, reassembled from their pieces in
        every column (the reference's ``all_gather`` over ``model``)."""
        cols = self._columns(cols)
        out, off = [], 0
        for plan in self.plans:
            size = plan.local_size
            if plan.model_dim is None:
                full = cols[:, off:off + size].reshape(-1)
                full = full[: _prod(plan.global_shape)]
                out.append(full.reshape(plan.global_shape).to(plan.dtype))
            else:
                piece = cols[int(m_idx), off:off + size]
                out.append(piece.reshape(plan.local_shape).to(plan.dtype))
            off += size
        return out

    def unflatten(self, cols: Tensor) -> list:
        """All columns → the whole leaves (sharded leaves concatenated
        along their model dim)."""
        cols = self._columns(cols)
        per_col = [self.local_unflatten(cols, m) for m in range(self.m)]
        out = []
        for i, plan in enumerate(self.plans):
            if plan.model_dim is None or self.m == 1:
                out.append(per_col[0][i])
            else:
                out.append(torch.cat([c[i] for c in per_col],
                                     plan.model_dim))
        return out
