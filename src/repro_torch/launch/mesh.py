"""Mesh construction (port of :mod:`repro.launch.mesh`).

The port's mesh is one process over local torch devices: a named grid of
ranks, each with its device, in JAX's row-major rank order (the last axis
varies fastest). A device may repeat — ``["cuda:0"] * 8`` puts eight ranks
on one card, ``["cpu"] * 8`` runs them on the CPU — the counterpart of the
reference's ``--xla_force_host_platform_device_count``. There is no
``torch.distributed``: the train step loops over the ranks.

A mesh also fixes the *aggregation client set*: the combined DP axes
(``pod`` × ``data``) are the K clients of the multi-hop round.
:func:`make_agg_plan` compiles any topology over exactly that client count.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes and one device per rank (row-major over the axes)."""

    axis_names: tuple
    axis_sizes: tuple
    devices: tuple

    def __post_init__(self):
        from repro_torch.agg.device import _canonical
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "axis_sizes",
                           tuple(int(s) for s in self.axis_sizes))
        object.__setattr__(self, "devices",
                           tuple(_canonical(d) for d in self.devices))
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} axis sizes")
        if len(self.devices) != math.prod(self.axis_sizes):
            raise ValueError(f"mesh of shape {self.axis_sizes} given "
                             f"{len(self.devices)} devices")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, rank: int) -> dict:
        """Axis coordinates of a flat rank."""
        out = {}
        for name, size in reversed(list(zip(self.axis_names,
                                            self.axis_sizes))):
            out[name] = rank % size
            rank //= size
        return out

    def rank_of(self, **coords) -> int:
        """Flat rank of the given coordinates (missing axes at 0)."""
        r = 0
        for name, size in zip(self.axis_names, self.axis_sizes):
            r = r * size + int(coords.get(name, 0))
        return r

    def device_of(self, **coords) -> torch.device:
        return self.devices[self.rank_of(**coords)]

    def distinct(self) -> tuple:
        """The mesh's devices in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(shape, axes, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over ``axes``. ``devices=None`` takes one CUDA
    device per rank and raises when there are fewer (or no card at all —
    it never takes the CPU); an explicit list names each rank's device in
    rank order and may repeat one."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = math.prod(shape)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"the mesh needs {n} CUDA devices and no CUDA device is "
                f"available; pass devices=['cpu'] * {n} to run it on the "
                f"CPU")
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(
                f"mesh {shape} needs {n} devices, have {have} (pass "
                f"devices=['cuda:0'] * {n} to put several ranks on one "
                f"card)")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(axis_names=axes, axis_sizes=shape, devices=tuple(devices))


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """16×16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod (needs that
    many cards unless ``devices`` names them)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_host_mesh(device=None) -> Mesh:
    """Single-rank mesh (smoke tests / examples) on ``device`` (the card
    unless asked)."""
    from repro_torch.device import resolve_device
    return make_mesh((1, 1), ("data", "model"), [resolve_device(device)])


def dp_clients(mesh) -> int:
    """Number of aggregation clients a mesh provides (pod × data size)."""
    from repro_torch.train.step import dp_size   # the one source of the rule
    return dp_size(mesh)


def make_agg_plan(mesh, topology: Any = None, *,
                  pad_to: Optional[tuple] = None, q_budget=None):
    """Compile ``topology`` into an AggPlan sized for ``mesh``'s DP ring.

    ``None`` gives the rotated ring's chain plan (the paper baseline); an
    ``AggTree``, chain order, ``ConstellationGraph``, or int K goes through
    :func:`repro_torch.agg.compile_plan` with ``num_clients`` pinned to the
    mesh. Nested (staged) topologies compile to a
    :class:`~repro_torch.agg.nested.NestedPlan`: ``"hierarchical"`` gives
    the two-stage pod chain×chain over the mesh's (pod, data) axes; a
    ``NestedPlan``, a routed ``NestedTopology`` or an explicit stage spec
    goes through :func:`repro_torch.agg.compile_nested`.
    """
    from repro_torch.agg import compile_nested, compile_plan, pod_ring_nested
    from repro_torch.agg.device import ring_chain_plan, ring_chain_tree
    from repro_torch.agg.nested import NestedPlan

    k = dp_clients(mesh)
    if topology is None:
        # the ring chain even when padded/budgeted — NOT path_tree(k),
        # whose reversed visiting order is a bitwise-different chain
        if pad_to is None and q_budget is None:
            return ring_chain_plan(k)
        topology = ring_chain_tree(k)
    if isinstance(topology, str) and topology == "hierarchical":
        from repro_torch.train.step import dp_axes
        axes = dp_axes(mesh)
        if len(axes) < 2:
            raise ValueError(
                f"'hierarchical' needs two DP axes (pod, data); mesh has "
                f"{axes}")
        k_data = mesh.shape[axes[-1]]
        nested = pod_ring_nested(k // k_data, k_data, q_budget=q_budget)
        return nested if pad_to is None else nested.pad(pad_to)
    if isinstance(topology, NestedPlan) or hasattr(topology,
                                                   "nested_stages"):
        nested = compile_nested(topology, num_clients=k, q_budget=q_budget,
                                pad_to=pad_to)
        if nested.num_clients != k:
            raise ValueError(f"nested topology has {nested.num_clients} "
                             f"clients but the mesh provides {k} DP ranks")
        return nested
    return compile_plan(topology, num_clients=k, pad_to=pad_to,
                        q_budget=q_budget)
