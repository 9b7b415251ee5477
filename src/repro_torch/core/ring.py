"""Rotated sparse ring reduce-scatter (port of :mod:`repro.core.ring`).

The flattened per-rank gradient is split into K segments; segment j's
K-hop chain starts at rank j and walks the ring, every hop folding that
rank's contribution with the configured node step (Alg 1–5). After the
final shift rank r owns the fully-aggregated segment r.

Per segment, the value path is the chain's on that segment with the
per-segment budget ``segment_budget(q, K)`` (block-wise Top-Q). The ring is
the chain specialization of the rotated-segment lowering:
:func:`rotated_ring_local` runs the ring's chain plan
(:func:`repro_torch.agg.device.ring_chain_plan`, every transport offset
+1) through :func:`repro_torch.agg.device.run_plan_segments_local`.

The reference runs this inside ``shard_map`` with one SPMD body per rank;
the port has one controller over a
:class:`~repro_torch.agg.device.ClientMesh`, takes per-rank lists and
returns per-rank lists. The caller sums the per-rank :class:`RingStats`
(the reference's ``psum``).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


class RingStats(NamedTuple):
    """Wire accounting, summed over one rank's hops (0-d leaves; ``[B]``
    in the cohort-batched form)."""

    bits: Tensor       # exact paper-§V bits transmitted by this rank
    nnz: Tensor        # total nonzeros transmitted (float32 against overflow)
    err_sq: Tensor     # Σ‖e‖² after the round (local sparsification error)


def ring_hops(num_ranks: int) -> int:
    """Wire transmissions per rank per round (K−1 ring + 1 ownership shift)."""
    return num_ranks


def rotated_ring_local(cfg, mesh, flat: Sequence[Tensor],
                       ef: Sequence[Tensor], weight, *,
                       global_mask: Optional[Sequence[Tensor]] = None,
                       participate=None) -> tuple:
    """Run the rotated ring over ``mesh``: per rank ``[n]`` gradient slice
    and EF on ``mesh.devices[r]`` (``n % K == 0``).

    Returns per-rank lists ``(final segment [n // K], new EF [n],
    RingStats)``; rank r holds the fully-aggregated segment r. The ring's
    chain plan through :func:`~repro_torch.agg.device.
    run_plan_segments_local` with static transport: one shift by +1 per
    level, on the register path.
    """
    from repro_torch.agg.device import (ring_chain_plan,
                                        run_plan_segments_local)

    return run_plan_segments_local(
        cfg, ring_chain_plan(mesh.size), mesh, flat, ef, weight,
        global_mask=global_mask, participate=participate,
        transport="static")


# ---------------------------------------------------------------------------
# Flat layout helpers (the naive, unsharded layout)
# ---------------------------------------------------------------------------

def _leaves(tree: Any) -> list:
    from repro_torch.models.transformer import tree_leaves
    return tree_leaves(tree)


def _size(leaf) -> int:
    return int(math.prod(leaf.shape))


def padded_flat_dim(tree_or_specs: Any, multiple: int) -> int:
    """Σ leaf sizes, padded up to ``multiple`` (= model×data×pod sizes).
    Leaves are tensors (any device, ``meta`` included) or anything with a
    ``shape``."""
    total = sum(_size(leaf) for leaf in _leaves(tree_or_specs))
    return -(-total // multiple) * multiple


def flatten_tree(tree: Any, d_pad: int, dtype=torch.float32,
                 aligned_axis: Optional[Any] = None) -> Tensor:
    """Dict tree → flat ``[d_pad]`` (row-major per leaf, sorted-key leaf
    order). ``aligned_axis`` is reserved, as in the reference; ``None``
    gives the naive layout."""
    flat = torch.cat([leaf.reshape(-1).to(dtype) for leaf in _leaves(tree)])
    return F.pad(flat, (0, d_pad - flat.shape[0]))


def flatten_stacked(tree: Any, d_pad: int, dtype=torch.float32) -> Tensor:
    """Tree with a leading stack dim K on every leaf → ``[K, d_pad]``."""
    leaves = _leaves(tree)
    k = leaves[0].shape[0]
    flat = torch.cat([leaf.reshape(k, -1).to(dtype) for leaf in leaves],
                     dim=1)
    return F.pad(flat, (0, d_pad - flat.shape[1]))


def unflatten_tree(template: Any, flat: Tensor) -> Any:
    """Inverse of :func:`flatten_tree` (``template`` supplies the keys,
    shapes and dtypes)."""
    from repro_torch.core.flat_layout import tree_structure, tree_unflatten
    out, off = [], 0
    for leaf in _leaves(template):
        size = _size(leaf)
        out.append(flat[off:off + size].reshape(leaf.shape).to(leaf.dtype))
        off += size
    return tree_unflatten(tree_structure(template), out)


def segment_budget(q_total: int, num_segments: int) -> int:
    """Per-segment per-hop budget (block-wise Top-Q).

    Floor division, so summed per-segment budgets never exceed the global
    §V budget: ``num_segments · segment_budget(q, n) ≤ q``. When
    ``q_total < num_segments`` the budget is 0 and those segments transmit
    nothing.
    """
    if num_segments <= 0:
        raise ValueError(f"num_segments must be positive, got {num_segments}")
    return max(0, q_total) // num_segments
