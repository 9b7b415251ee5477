"""Tensor parallelism over the ``model`` axis: one client's forward and
backward split over its M ranks (the reference's GSPMD compute over
:func:`~repro_torch.models.partition.param_pspecs`).

The reference runs ``per_client`` under a ``shard_map`` manual over the DP
axes only, so GSPMD splits each client's work over ``model``: heads for
``wq/wk/wv/wo`` (and biases), ``d_ff`` for the MLP and the MoE experts, the
vocabulary for ``embed`` and ``lm_head``. The port has one controller over
local devices: :class:`TP` holds client k's rank devices (rank (k, m) on
``devices[m]``), and its two cross-rank ops are autograd functions, so one
``torch.autograd.grad`` carries the gradient across the devices:

* :meth:`TP.scatter` — a replicated activation from rank 0's device to
  every rank (Megatron's ``f``); its backward sums the ranks' gradients;
* :meth:`TP.reduce` — the ranks' partial results summed on rank 0's device
  (``g``, the all-reduce after a row-parallel product); its backward copies
  the gradient back to every rank.

Both sums run in a fixed pairwise order (:func:`pair_sum`, the rule of
``agg/device.py::_slot_sum``) and in float32 with the sum cast back, as the
reference's program sums: the probe of its (4, 2) program's HLO finds every
``model`` all-reduce of a bf16 activation promoted to f32
(``add.clone_promoted``), forward and backward.

**What runs where.** The column- and row-parallel blocks run on every rank,
each on its own shards: ``wq/wk/wv`` by heads (GQA with the kv heads
replicated: each rank takes the kv heads its q heads use), ``w_gate/w_up``
by ``d_ff`` with ``w_down`` row-parallel, the MoE experts' ``d_ff``, the
vocab-parallel ``embed`` lookup (masked to the rank's vocab range, summed)
and logits (the ``-1e30`` pad mask on the shard that owns the pad slots),
and the vocab-parallel cross-entropy (max, Σ exp and the label's logit each
reduced over the ranks). Attention whose q heads do not divide M splits by
query sequence where the reference's ``_constrain_scores`` pins the scores'
query dim to ``model`` (:func:`~repro_torch.models.attention.query_blocks`):
rank m attends with query rows ``[m·S/M, (m+1)·S/M)`` and the whole
weights, and the blocks are concatenated on rank 0's device. The replicated
work — norms, residual adds, RoPE of replicated kv heads, the MoE router
and its dispatch, mamba blocks, any block whose leaf is replicated because
its ``d_ff`` or vocabulary do not divide M (or its heads, where
``query_blocks`` leaves the attention whole), the frontends' ``torch.where``
and add — runs **once**, on rank 0's device, with the output copied by
:meth:`TP.scatter`. The
reference runs it on every rank; the port's ranks may share one card (the
one-card mesh), where M copies would cost M times the work for the same
numbers, and running it once keeps the routing of an MoE identical on every
rank by construction (every expert shard drops the same tokens). A
replicated leaf's gradient is then whole on rank 0, and rank m takes its
column's piece of it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.device import to_device

Tensor = torch.Tensor


def pair_sum(xs: Sequence[Tensor]) -> Tensor:
    """Σ of ``xs`` in ``_slot_sum``'s fixed pairwise order: ``x[i] +
    x[i + h]`` for the first h = n // 2, an odd last one carried. Each add
    runs on ``x[i]``'s device with ``x[i + h]`` moved there (a tree
    reduction: a device holds its own term and one other at a time), and
    the sum lands on ``xs[0]``'s device; the adds are the same on any
    device, so the bits do not depend on where the terms lie."""
    xs = list(xs)
    while len(xs) > 1:
        h = len(xs) // 2
        xs = [xs[i] + to_device(xs[i + h], xs[i].device)
              for i in range(h)] + xs[2 * h:]
    return xs[0]


def sum_to(parts: Sequence[Tensor], dev, dtype=None) -> Tensor:
    """Σ of ``parts`` (any devices) on ``dev``: each upcast to float32
    where it lies, summed by :func:`pair_sum`, cast to ``dtype`` (the
    parts' own by default)."""
    dtype = parts[0].dtype if dtype is None else dtype
    total = pair_sum([p.float() for p in parts])
    return to_device(total.to(dtype), torch.device(dev))


def _copy(x: Tensor, dev) -> Tensor:
    """``x`` on ``dev``: a copy, or a view of ``x`` already there (an
    autograd function returns each output as a tensor of its own)."""
    y = to_device(x, torch.device(dev))
    return x.view_as(x) if y is x else y


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices):
        ctx.src = x.device
        return tuple(_copy(x, d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        return sum_to(grads, ctx.src), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dst, *parts):
        ctx.devs = [p.device for p in parts]
        return sum_to(parts, dst)

    @staticmethod
    def backward(ctx, grad):
        return (None,) + tuple(_copy(grad, d) for d in ctx.devs)


class TP:
    """Client k's M ranks: ``devices[m]`` is rank (k, m)'s device, and
    rank 0's device computes the replicated work."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        self.m = len(self.devices)
        self.home = self.devices[0]

    def scatter(self, x: Tensor) -> tuple:
        """``x`` (on rank 0's device) on every rank's device."""
        return _Scatter.apply(x, self.devices)

    def reduce(self, parts: Sequence[Tensor]) -> Tensor:
        """The ranks' partial results summed on rank 0's device."""
        if len(parts) != self.m:
            raise ValueError(f"{len(parts)} partial results for {self.m} "
                             f"ranks")
        return _Reduce.apply(self.home, *parts)

    def max(self, parts: Sequence[Tensor]) -> Tensor:
        """The elementwise max of the ranks' values on rank 0's device
        (exact in any order; no gradient)."""
        out = to_device(parts[0].detach(), self.home)
        for p in parts[1:]:
            out = torch.maximum(out, to_device(p.detach(), self.home))
        return out

    def split(self, n: int) -> tuple:
        """Whether ``n`` (heads, ``d_ff``, vocabulary) divides over the
        ranks, and each rank's share."""
        ok = n % self.m == 0
        return ok, (n // self.m if ok else n)


def check_shape(x: Tensor, shape: tuple, what: str) -> Tensor:
    """``x`` if its shape is ``shape``; a shard that does not match its
    spec raises."""
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: rank shard of shape {tuple(x.shape)}, "
                         f"its spec gives {tuple(shape)}")
    return x
