"""The assembled train step (and serve steps); port of
:mod:`repro.train.step`.

The reference compiles one SPMD program over a (pod, data, model) mesh.
The port has one controller over a :class:`~repro_torch.launch.mesh.Mesh`
of local devices and runs the same three phases as named methods of
:class:`TrainStep`, so each can be held alone:

  1. :meth:`TrainStep.phase1` (the reference's ``per_client``; one client
     is :meth:`TrainStep.client_cols`) — per-client gradients, flattened
     to their M model columns. On a mesh with ``model == 1`` client k runs
     ``loss_fn`` + autograd whole on rank (k, 0)'s device
     (:meth:`TrainStep.client_grad`). With ``model > 1`` its M ranks split
     the work in the form the reference chooses
     (``batch_over_model = family in ("ssm", "hybrid") or
     tc.fsdp_compute``, and the client's batch divides M):

     * **tensor-parallel** (:mod:`repro_torch.models.tp`,
       :func:`~repro_torch.models.model.loss_fn_tp`): rank (k, m) computes
       on its shards of the params by ``param_pspecs``, on its device, and
       one autograd runs across the ranks' devices; its gradients are
       column m's pieces (a replicated leaf's whole gradient sits on rank
       (k, 0), which computes the replicated work, and rank m takes its
       column's piece);
     * **batch over model**: rank (k, m) takes sub-batch m of the client's
       slice, gathers the model-sharded leaves whole onto its device
       (FSDP-style) and runs ``loss_fn`` + autograd there; the client's
       gradient is the mean over m, summed so that rank (k, m) keeps only
       column m's piece (a reduce-scatter). An MoE takes it only where
       each sub-batch is a whole number of the client's routing groups;
       its M sub-batches then form one loss, the aux from the fractions'
       means over the ranks, under one autograd
       (:meth:`TrainStep._moe_over_model`).

     Every cross-rank sum runs in float32 in a fixed pairwise order (the
     reference's program promotes its bf16 all-reduces to f32). The
     reported loss is the mean of the per-client losses, summed in client
     order;
  2. :meth:`TrainStep.aggregate` — sparse incremental aggregation in the
     shard-aligned flat space (:mod:`repro_torch.core.flat_layout`): each
     (k, m) rank flattens its client's gradient to ``agg_dtype``
     (:meth:`TrainStep.flatten_grads`), the TCS mask is ``|Δ| ≥ τ_G`` with
     τ_G the sharded search over the M model columns
     (:meth:`TrainStep.tcs_masks`), and each model column runs its own
     rotated-segment round over the K_dp ranks
     (:func:`~repro_torch.agg.device.run_plan_segments_local`, static
     transport; :func:`~repro_torch.agg.device.run_nested_segments_local`
     for nested topologies). The per-rank stats are summed over every rank
     in a fixed pairwise order;
  3. :meth:`TrainStep.update` — the flat optimizer on the fp32 master
     (``grad_est = agg / max(Σ w·p, 1e-9)``, :func:`lr_schedule`,
     :func:`apply_flat`; on a placed state piece by piece, each on its
     rank's device), the downlink (flat master → param tree), and the TCS
     reference refresh.

Rank (k, m) is DP rank k in model column m. It owns segment
``_owned_segment(k)`` of column m: its DP rank for flat topologies, its
position in stage order (reversed DP axes) for nested ones. The global
vectors do not depend on that order; only the ownership does. Where every
rank shares one device (``["cuda:0"] * K``, ``["cpu"] * K``) the
:class:`~repro_torch.train.state.TrainState` keeps the reference's global
layout, whole tensors on that device, and each rank's piece is a view of
it. On a mesh of several devices :func:`init_state` places the state by
rank (:func:`place_state` places a whole one,
:func:`~repro_torch.train.state.gather_state` gathers it back), by the
specs of :func:`state_shardings`:

  ================================  ===================  ==================
  leaf                              spec                 where it lives
  ================================  ===================  ==================
  ``master``, ``opt.m``, ``opt.v``  :func:`flat_spec`    rank (k, m): its
                                    (nested:             owned segment of
                                    :func:`nested_flat_  column m, ``seg``
                                    spec`)               long
  ``ef``, each ``stage_ef`` tier    ``(dp, "model")``    rank (k, m): row k,
                                                         column block m
  ``params``                        ``param_pspecs``     rank (k, m): shard
                                                         m of each sharded
                                                         leaf, replicated
                                                         leaves whole
  ``tcs_prev``                      ``param_pspecs``     as the params
  ``step``, ``opt.step``            replicated           the mesh's first
                                                         device
  ================================  ===================  ==================

The flat leaves are :class:`~repro_torch.train.state.RankPieces`, the
params and ``tcs_prev`` :class:`~repro_torch.train.state.RankShards` (one
tree per distinct (device, column) of the ranks). Phase 1 reads each
rank's tree; the TCS mask's Δ for column m is made on rank (0, m)'s device
from that rank's params and ``tcs_prev``; the downlink rebuilds each
rank's tree from column m's K_dp master segments (a replicated leaf's
other columns gathered over m), leaf by leaf, so no device holds a whole
f32 master; the ``tcs_prev`` refresh casts each rank's own tree.

:func:`build_prefill_step` and :func:`build_serve_step` run whole on a mesh
of one rank, and on a mesh of several split over the ranks with the
params and cache placed by ``param_pspecs`` and ``cache_pspecs``
(:mod:`repro_torch.models.serve_split`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch

from repro_torch.agg.device import _slot_sum, client_mesh
from repro_torch.configs.base import ModelConfig
from repro_torch.core import ring as ring_mod
from repro_torch.core import sparsify as sp
from repro_torch.core.algorithms import AggConfig
from repro_torch.core.flat_layout import (FlatLayout, tree_structure,
                                          tree_unflatten)
from repro_torch.device import to_device
from repro_torch.kernels import ops as kops
from repro_torch.models import model as model_mod
from repro_torch.models import partition
from repro_torch.models.moe import GROUP_SIZE
from repro_torch.models.tp import TP, sum_to
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.optim import optimizers as opt_mod
from repro_torch.optim.schedule import lr_schedule
from repro_torch.train.state import (RankPieces, RankShards, TrainConfig,
                                    TrainState, map_state, state_to)

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def dp_axes(mesh) -> tuple:
    return partition.batch_axes(mesh)


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def model_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def flat_spec(mesh) -> tuple:
    """Layout of the flat master/opt/aggregate: model-major, then ring."""
    return (("model",) + dp_axes(mesh),)


# ---------------------------------------------------------------------------
# Nested (staged) aggregation topology plumbing
# ---------------------------------------------------------------------------

def nested_stage_axes(mesh, n_stages: int) -> tuple:
    """Per-stage mesh axes for a nested plan over this mesh's DP ring.

    Stage 0 runs on the *minor* DP axis (client k = pod·K_d + data ⇒
    mesh-aligned clusters), each later stage one axis up; the last stage
    takes whatever DP axes remain as one flattened ring. For the
    (pod, data) mesh and a 2-stage plan this is ``("data", "pod")``.
    """
    dp = dp_axes(mesh)
    if len(dp) < n_stages:
        raise ValueError(f"a {n_stages}-stage nested plan needs ≥"
                         f"{n_stages} DP axes; mesh has {dp}")
    axes = [dp[len(dp) - 1 - s] for s in range(n_stages - 1)]
    rest = dp[:len(dp) - (n_stages - 1)]
    axes.append(rest[0] if len(rest) == 1 else tuple(rest))
    return tuple(axes)


def _stage_order(axes) -> tuple:
    """Flatten per-stage axes into one name tuple, stage order."""
    out: list = []
    for a in axes:
        out.extend(a if isinstance(a, tuple) else (a,))
    return tuple(out)


def nested_flat_spec(mesh, axes) -> tuple:
    """Flat master/opt/aggregate layout under staged aggregation: rank
    coords own [stage-0 segment, stage-1 sub-segment, …] — the dp axes in
    *stage* order (reversed)."""
    return (("model",) + _stage_order(axes),)


def _resolve_topology(mesh, topology):
    """→ (flat topology | None, NestedPlan | None, stage axes | None)."""
    from repro_torch.agg.nested import (NestedPlan, compile_nested,
                                        pod_ring_nested)

    nested = None
    if isinstance(topology, str) and topology == "hierarchical":
        dp = dp_axes(mesh)
        if len(dp) < 2:
            raise ValueError(f"'hierarchical' needs ≥2 DP axes (pod, "
                             f"data); mesh has {dp}")
        k_minor = mesh.shape[dp[-1]]
        nested = pod_ring_nested(dp_size(mesh) // k_minor, k_minor)
    elif isinstance(topology, NestedPlan):
        nested = topology
    elif hasattr(topology, "nested_stages"):
        nested = compile_nested(topology, num_clients=dp_size(mesh))
    if nested is None:
        return topology, None, None
    if nested.num_clients != dp_size(mesh):
        raise ValueError(f"nested topology has {nested.num_clients} "
                         f"clients but the mesh provides "
                         f"{dp_size(mesh)} DP ranks")
    return None, nested, nested_stage_axes(mesh, nested.num_stages)


def _axis_size(mesh, a) -> int:
    n = 1
    for name in (a if isinstance(a, tuple) else (a,)):
        n *= mesh.shape[name]
    return n


def _stage_ef_dims(mesh, axes, d_flat: int) -> tuple:
    """Flat length of each upper EF tier: stage s's tier covers one
    stage-(s−1) output segment per rank column."""
    dims = []
    prefix = 1
    for a in axes[:-1]:
        prefix *= _axis_size(mesh, a)
        dims.append(d_flat // prefix)
    return tuple(dims)


@functools.lru_cache(maxsize=None)
def make_layout(cfg: ModelConfig, mesh) -> FlatLayout:
    template = model_mod.param_specs(cfg)
    return FlatLayout(template, partition.param_pspecs(cfg, mesh), mesh)


def global_q(tc: TrainConfig, d_flat: int) -> int:
    return max(1, int(tc.q_frac * d_flat))


def _segment_agg_cfg(tc: TrainConfig, mesh, d_flat: int) -> AggConfig:
    """Per-segment AggConfig: the global budget split over all segments."""
    n_segments = dp_size(mesh) * model_size(mesh)
    q = global_q(tc, d_flat)
    q_seg = ring_mod.segment_budget(q, n_segments)
    kw = dict(q=q_seg)
    if tc.needs_tcs():
        if q_seg == 0:
            # global budget smaller than the segment count: nothing to
            # split — the sub-budgets must not re-inflate §V bits
            kw.update(q_local=0, q_global=0)
        else:
            ql = max(1, round(q_seg * tc.agg.q_local / max(tc.agg.q, 1))
                     ) if tc.agg.q_local else max(1, q_seg // 10)
            kw.update(q_local=ql, q_global=max(q_seg - ql, 1))
    return dataclasses.replace(tc.agg, **kw)


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------

def _dp_coords(mesh, k: int) -> dict:
    """DP axis coordinates of DP rank k (row-major over the DP axes)."""
    out = {}
    for a in reversed(dp_axes(mesh)):
        out[a] = k % mesh.shape[a]
        k //= mesh.shape[a]
    return out


def rank_device(mesh, k: int, m: int = 0) -> torch.device:
    """Device of rank (DP rank k, model column m)."""
    coords = _dp_coords(mesh, k)
    if "model" in mesh.axis_names:
        coords["model"] = m
    return mesh.device_of(**coords)


def _owned_segment(mesh, k: int, order: Optional[tuple] = None) -> int:
    """Which of a column's K_dp segments DP rank k owns: its row-major
    index over ``order`` (the DP axes by default; stage order for nested
    topologies)."""
    coords = _dp_coords(mesh, k)
    r = 0
    for a in (dp_axes(mesh) if order is None else order):
        r = r * mesh.shape[a] + coords[a]
    return r


def _home(mesh) -> torch.device:
    return mesh.devices[0]


def _placed(mesh) -> bool:
    """Does ``mesh`` place its state by rank (several devices)?"""
    return len(mesh.distinct()) > 1


def param_places(mesh) -> tuple:
    """The distinct (device, model column) pairs of the ranks, in rank
    order: each holds one column's param tree."""
    return tuple(dict.fromkeys((rank_device(mesh, k, m), m)
                               for k, m in _ranks(mesh)))


def _block(mesh, coords: dict, entry) -> tuple:
    """(block index, block count) of a spec entry at rank ``coords``: the
    row-major index over the entry's axes."""
    idx, n = 0, 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        if a not in mesh.shape:
            continue
        idx = idx * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    return idx, n


def _shard_index(mesh, spec: tuple, shape: tuple, k: int, m: int) -> tuple:
    """Rank (k, m)'s index into a leaf of ``shape`` under ``spec`` (the
    leading ``None`` entries kept whole); a sharded axis with one entry a
    rank, not the last, is indexed by its position."""
    spec = tuple(spec)
    lead = 0
    while lead < len(spec) and spec[lead] is None:
        lead += 1
    if lead == len(spec) or any(e is None for e in spec[lead:]) \
            or len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not place a piece of {shape} "
                         f"per rank")
    coords = _dp_coords(mesh, k)
    coords["model"] = m
    ix = []
    for i, entry in enumerate(spec[lead:], lead):
        b, n = _block(mesh, coords, entry)
        size = shape[i] // n
        if size == 1 and i < len(shape) - 1:
            ix.append(b)
        else:
            ix.append(slice(b * size, (b + 1) * size))
    return tuple(ix), tuple(shape[lead:])


def _ranks(mesh) -> list:
    """(k, m) in rank order."""
    return [(k, m) for k in range(dp_size(mesh))
            for m in range(model_size(mesh))]


def _put(x: Tensor, dev) -> Tensor:
    """A copy of ``x`` of its own on ``dev``."""
    return torch.empty(x.shape, dtype=x.dtype, device=dev).copy_(x)


def _on(x: Tensor, dev) -> Tensor:
    """``x`` on exactly ``dev`` (``cpu`` and ``cpu:0`` are two mesh
    devices): itself if it is there, else a copy."""
    return x if x.device == torch.device(dev) else _put(x, dev)


def shard_leaf(x: Tensor, spec: tuple, mesh) -> RankPieces:
    """A whole leaf → its rank pieces under ``spec``, each copied to its
    rank's device."""
    pieces, index, tail = [], [], None
    for k, m in _ranks(mesh):
        ix, tail = _shard_index(mesh, spec, tuple(x.shape), k, m)
        pieces.append(_put(x[(Ellipsis,) + ix], rank_device(mesh, k, m)))
        index.append(ix)
    return RankPieces(pieces, index, tail)


def zeros_leaf(shape: tuple, dtype: torch.dtype, spec: tuple,
               mesh) -> RankPieces:
    """Zero rank pieces of a leaf of ``shape`` under ``spec``, each made on
    its rank's device."""
    pieces, index, tail = [], [], None
    probe = torch.empty(shape, dtype=dtype, device="meta")
    for k, m in _ranks(mesh):
        ix, tail = _shard_index(mesh, spec, tuple(shape), k, m)
        pieces.append(torch.zeros(probe[(Ellipsis,) + ix].shape, dtype=dtype,
                                  device=rank_device(mesh, k, m)))
        index.append(ix)
    return RankPieces(pieces, index, tail)


def shard_params(tree, specs, mesh) -> RankShards:
    """A whole param tree (or ``tcs_prev``) → its :class:`~repro_torch.
    train.state.RankShards` on ``mesh``: each (device, column) of the
    ranks gets its column's tree (:func:`~repro_torch.models.partition.
    shard` of every leaf by ``specs``), copied to that device."""
    m_size = model_size(mesh)
    structure = tree_structure(tree)
    leaves, spec_l = tree_leaves(tree), tree_leaves(specs)
    dims = [partition.model_dim(sp, tuple(x.shape), m_size)
            for x, sp in zip(leaves, spec_l)]
    places = param_places(mesh)
    trees = [tree_unflatten(structure, [
        _put(partition.shard(x, sp, m, m_size), dev)
        for x, sp in zip(leaves, spec_l)]) for dev, m in places]
    return RankShards([d for d, _ in places], [m for _, m in places], trees,
                      dims)


# ---------------------------------------------------------------------------
# State init
# ---------------------------------------------------------------------------

def _master_from_params(cfg: ModelConfig, mesh, layout: FlatLayout, params,
                        order=None) -> Tensor:
    """Flat fp32 master ``[d_flat]`` from the param tree.

    ``order`` is the rank→segment mapping (a flattened axis-name tuple):
    nested topologies own the flat space in stage order (reversed dp), see
    :func:`nested_flat_spec`. The global vector is the same for every
    order — column m, then its segments in coordinate order — so the
    order only decides which rank updates which piece.
    """
    if order is not None and set(order) != set(dp_axes(mesh)):
        raise ValueError(f"order {order} does not name the DP axes "
                         f"{dp_axes(mesh)}")
    return layout.flatten(tree_leaves(params), torch.float32)


def init_state(cfg: ModelConfig, tc: TrainConfig, mesh,
               generator: Optional[torch.Generator],
               topology: Any = None, cohorts: int = 1) -> TrainState:
    """Materializing init (params drawn from ``generator`` on the mesh's
    first device, as :func:`repro_torch.models.model.init_params`), placed
    as the module docstring says: whole on a mesh of one device, by rank on
    a mesh of several.

    ``topology`` must match the one later given to
    :func:`build_train_step`: a nested topology adds the upper EF tiers
    (``stage_ef``). ``cohorts=B`` stacks B tenant states drawn one after
    another from ``generator``, with a leading cohort axis on every leaf.
    """
    if cohorts > 1:
        if _resolve_topology(mesh, topology)[1] is not None:
            raise ValueError("cohort batches run flat topologies; nested "
                             "plans train per tenant")
        states = [init_state(cfg, tc, mesh, generator, topology)
                  for _ in range(cohorts)]
        return _stack_states(states)
    layout = make_layout(cfg, mesh)
    k_dp = dp_size(mesh)
    home = _home(mesh)
    _, nested, n_axes = _resolve_topology(mesh, topology)
    params = model_mod.init_params(cfg, generator, home)
    order = None if nested is None else _stage_order(n_axes)
    master = _master_from_params(cfg, mesh, layout, params, order=order)
    ef_dt = _dtype(tc.ef_dtype)
    tier_dims = (() if nested is None else
                 _stage_ef_dims(mesh, n_axes, layout.d_flat))
    tcs_prev = None
    if tc.needs_tcs():
        tcs_prev = tree_map(lambda p: p.to(_dtype(tc.agg_dtype)), params)
    step = torch.zeros((), dtype=torch.int32, device=home)
    if not _placed(mesh):
        opt = opt_mod.init_flat(tc.opt, layout.d_flat, like=master)
        ef = torch.zeros((k_dp, layout.d_flat), dtype=ef_dt, device=home)
        stage_ef = None
        if nested is not None:
            stage_ef = tuple(
                torch.zeros((k_dp, dim), dtype=ef_dt, device=home)
                for dim in tier_dims)
        return TrainState(step=step, params=params, master=master, opt=opt,
                          ef=ef, tcs_prev=tcs_prev, stage_ef=stage_ef)
    specs = state_shardings(cfg, tc, mesh, topology)
    flat = (layout.d_flat,)
    opt = opt_mod.FlatOptState(
        step=torch.zeros((), dtype=torch.int32, device=home),
        m=(None if specs.opt.m is None else
           zeros_leaf(flat, torch.float32, specs.opt.m, mesh)),
        v=(None if specs.opt.v is None else
           zeros_leaf(flat, torch.float32, specs.opt.v, mesh)))
    return TrainState(
        step=step, params=shard_params(params, specs.params, mesh),
        master=shard_leaf(master, specs.master, mesh), opt=opt,
        ef=zeros_leaf((k_dp, layout.d_flat), ef_dt, specs.ef, mesh),
        tcs_prev=(None if tcs_prev is None else
                  shard_params(tcs_prev, specs.tcs_prev, mesh)),
        stage_ef=None if nested is None else tuple(
            zeros_leaf((k_dp, dim), ef_dt, spec, mesh)
            for dim, spec in zip(tier_dims, specs.stage_ef)))


def place_state(state: TrainState, mesh, specs: TrainState) -> TrainState:
    """A state of whole tensors (the reference's global layout, on any
    device) placed on ``mesh`` as :func:`init_state` places it: by the
    specs of :func:`state_shardings` (``specs``) on a mesh of several
    devices, whole on the device of a mesh of one."""
    home = _home(mesh)
    if not _placed(mesh):
        return state_to(state, home)

    def shard(x, spec):
        return None if x is None else shard_leaf(x, spec, mesh)

    return TrainState(
        step=_on(state.step, home),
        params=shard_params(state.params, specs.params, mesh),
        master=shard(state.master, specs.master),
        opt=opt_mod.FlatOptState(step=_on(state.opt.step, home),
                                 m=shard(state.opt.m, specs.opt.m),
                                 v=shard(state.opt.v, specs.opt.v)),
        ef=shard(state.ef, specs.ef),
        tcs_prev=(None if state.tcs_prev is None else
                  shard_params(state.tcs_prev, specs.tcs_prev, mesh)),
        stage_ef=None if state.stage_ef is None else tuple(
            shard(e, sp) for e, sp in zip(state.stage_ef, specs.stage_ef)))


def _stack_states(states: list):
    """Stack a list of equal-structure states on a new leading axis."""
    first = states[0]
    if first is None:
        return None
    if isinstance(first, RankPieces):
        return RankPieces([torch.stack([s.pieces[r] for s in states])
                           for r in range(len(first.pieces))],
                          first.index, first.tail)
    if isinstance(first, RankShards):
        return RankShards(first.devices, first.cols, [
            _stack_states([s.trees[i] for s in states])
            for i in range(len(first.trees))],
            [None if d is None else d + 1 for d in first.dims])
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack_states([getattr(s, f) for s in states])
                             for f in first._fields))
    if isinstance(first, dict):
        return {k: _stack_states([s[k] for s in states]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack_states([s[i] for s in states])
                     for i in range(len(first)))
    return torch.stack(states)


def _cohort(state, i: int):
    """Tenant i of a cohort-stacked state (views)."""
    return map_state(lambda x: x[i], state)


def _cohort_spec(spec: tuple) -> tuple:
    """Prepend an unsharded leading cohort axis to a spec."""
    return (None,) + tuple(spec)


def _map_specs(fn, specs):
    """``fn`` on every spec (a tuple of axis entries) of a dict tree."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def state_shardings(cfg: ModelConfig, tc: TrainConfig, mesh,
                    topology: Any = None, cohorts: int = 1) -> TrainState:
    """The reference's ``state_shardings`` as spec data: a
    :class:`~repro_torch.train.state.TrainState` of plain-tuple specs (as
    :func:`~repro_torch.models.partition.param_pspecs` gives them) saying
    what each rank owns under the reference's program. Params and
    ``tcs_prev`` by ``param_pspecs``; master and the optimizer moments by
    :func:`flat_spec` (:func:`nested_flat_spec` for nested topologies);
    ``ef`` and each ``stage_ef`` tier by ``(dp axes, "model")``; the steps
    replicated. Pass the same ``topology``/``cohorts`` as
    :func:`build_train_step`: cohort batches add an unsharded leading
    axis to every leaf."""
    _, nested, n_axes = _resolve_topology(mesh, topology)
    fs = flat_spec(mesh) if nested is None else nested_flat_spec(mesh,
                                                                 n_axes)
    dp = dp_axes(mesh)
    coh = _cohort_spec if cohorts > 1 else tuple
    p_specs = _map_specs(coh, partition.param_pspecs(cfg, mesh))
    opt_m = None if tc.opt.name == "sgd" else coh(fs)
    opt_v = coh(fs) if tc.opt.name == "adamw" else None
    tcs = (_map_specs(coh, partition.param_pspecs(cfg, mesh))
           if tc.needs_tcs() else None)
    stage_ef = None
    if nested is not None:
        stage_ef = tuple(coh((dp, "model"))
                         for _ in range(nested.num_stages - 1))
    return TrainState(
        step=coh(()),
        params=p_specs,
        master=coh(fs),
        opt=opt_mod.FlatOptState(step=coh(()), m=opt_m, v=opt_v),
        ef=coh((dp, "model")),
        tcs_prev=tcs,
        stage_ef=stage_ef,
    )


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

class TrainStep:
    """``step(state, batch) → (state, metrics)``; see the module docstring
    for the phases. Built by :func:`build_train_step`."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, mesh,
                 topology: Any = None, telemetry: bool = False,
                 cohorts: int = 1):
        from repro_torch.agg.device import ring_chain_plan
        from repro_torch.agg.plan import AggPlan, compile_plan

        self.cfg, self.tc, self.mesh = cfg, tc, mesh
        self.telemetry, self.cohorts = telemetry, cohorts
        self.layout = layout = make_layout(cfg, mesh)
        self.k_dp = k_dp = dp_size(mesh)
        self.m = model_size(mesh)
        self.home = _home(mesh)
        self.agg_cfg = _segment_agg_cfg(tc, mesh, layout.d_flat)
        _, self.nested, self.n_axes = _resolve_topology(mesh, topology)
        if cohorts > 1 and self.nested is not None:
            raise ValueError("cohort batches run flat topologies; nested "
                             "plans train per tenant")
        if self.nested is not None:
            self.plan = self.nested
            self.order = _stage_order(self.n_axes)
            self.sizes = tuple(_axis_size(mesh, a) for a in self.n_axes)
        else:
            if topology is None:
                self.plan = ring_chain_plan(k_dp)
            elif isinstance(topology, AggPlan):
                self.plan = topology
            else:
                self.plan = compile_plan(topology, num_clients=k_dp)
            if self.plan.num_clients != k_dp:
                raise ValueError(f"topology has {self.plan.num_clients} "
                                 f"clients but the mesh provides {k_dp} DP "
                                 f"ranks")
            self.order = None
        self.agg_dt = _dtype(tc.agg_dtype)
        self.needs_tcs = tc.needs_tcs()
        self.qg_total = 0
        if self.needs_tcs:
            self.qg_total = max(1, int(
                global_q(tc, layout.d_flat) * self.agg_cfg.q_global
                / max(self.agg_cfg.q_global + self.agg_cfg.q_local, 1)))
        self.seg = layout.n_local // k_dp
        self.owned = [_owned_segment(mesh, k, self.order)
                      for k in range(k_dp)]
        self.col_meshes = [
            client_mesh(k_dp, devices=[rank_device(mesh, k, m)
                                       for k in range(k_dp)])
            for m in range(self.m)]
        self.structure = tree_structure(model_mod.param_specs(cfg))
        self.placed = _placed(mesh)
        self.p_specs = partition.param_pspecs(cfg, mesh)
        self.places = param_places(mesh)
        # the reference's choice of phase-1 form (repro/train/step.py)
        self.batch_over_model = (cfg.family in ("ssm", "hybrid")
                                 or tc.fsdp_compute)
        # rank (k, m)'s piece of a flat leaf (and of the aggregate)
        n = layout.n_local
        self.flat_index = [
            (slice(m * n + self.owned[k] * self.seg,
                   m * n + (self.owned[k] + 1) * self.seg),)
            for k, m in _ranks(mesh)]

    # ---- phase 1: per-client gradients ---------------------------------
    def _check_form(self, state: TrainState) -> None:
        if isinstance(state.master, RankPieces) != self.placed:
            raise ValueError(
                "a mesh of several devices takes a state placed by rank, a "
                "mesh of one a whole state (init_state and place_state "
                "give the mesh's form)")

    def _rank_trees(self, params, k: int) -> list:
        """Rank (k, m)'s param tree for each m: its tree of a
        :class:`~repro_torch.train.state.RankShards`, or views of the whole
        params of a mesh of one device."""
        if isinstance(params, RankShards):
            return [params.on(rank_device(self.mesh, k, m), m)
                    for m in range(self.m)]
        return [partition.rank_params(params, self.p_specs, m, self.m)
                for m in range(self.m)]

    def _client_slice(self, batch: dict, k: int) -> tuple:
        b = batch["tokens"].shape[0]
        if b % self.k_dp:
            raise ValueError(f"global batch {b} does not split over "
                             f"{self.k_dp} DP ranks")
        per = b // self.k_dp
        return per, {name: v[k * per:(k + 1) * per]
                     for name, v in batch.items()}

    def client_grad(self, params, batch: dict, k: int) -> tuple:
        """Client k's ``(gradient leaves, loss)`` on its slice of the
        global batch, whole on the device of rank (k, 0): the form of a
        mesh with ``model == 1``, and with ``model > 1`` the whole-model
        gradient that the split forms are held to (the params gathered
        there)."""
        dev = rank_device(self.mesh, k, 0)
        if isinstance(params, RankShards):
            params = (params.on(dev, 0) if self.m == 1 else
                      params.gather(dev))
        _, local = self._client_slice(batch, k)
        leaves = [to_device(p, dev).detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        local = {name: to_device(v, dev) for name, v in local.items()}
        with torch.enable_grad():
            loss, _ = model_mod.loss_fn(
                self.cfg, tree_unflatten(self.structure, leaves), local)
            grads = torch.autograd.grad(loss, leaves)
        return list(grads), loss.detach()

    def phase1_form(self, batch: dict) -> str:
        """``"whole"`` (``model == 1``), ``"batch_over_model"`` or
        ``"tensor_parallel"``: the reference's choice, by family,
        ``fsdp_compute`` and whether the client's batch divides M.

        An MoE (``fsdp_compute``) splits its batch only where each
        sub-batch is a whole number of the client's routing groups
        (``min(1024, per·S)`` tokens, ``models/moe.py``): there the
        sub-batches route as the whole batch does, and the aux is formed
        once from the client-wide fractions. Elsewhere a split would change
        which tokens each group drops, so it takes the tensor-parallel
        form, which routes the whole batch once on rank (k, 0)."""
        if self.m == 1:
            return "whole"
        per = batch["tokens"].shape[-2] // self.k_dp
        if self.batch_over_model and per % self.m == 0:
            if self.cfg.family != "moe":
                return "batch_over_model"
            seq = batch["tokens"].shape[-1]
            if (per // self.m) * seq % min(GROUP_SIZE, per * seq) == 0:
                return "batch_over_model"
        return "tensor_parallel"

    def client_cols(self, params, batch: dict, k: int) -> tuple:
        """Client k's ``(M column pieces [n_local] in agg_dtype, column m
        on rank (k, m)'s device; loss)`` in the form of
        :meth:`phase1_form`."""
        form = self.phase1_form(batch)
        if form == "whole":
            g, loss = self.client_grad(params, batch, k)
            return self.flatten_grads(g, k), loss
        if form == "batch_over_model":
            return self._client_batch_over_model(params, batch, k)
        return self._client_tensor_parallel(params, batch, k)

    def _devices(self, k: int) -> list:
        return [rank_device(self.mesh, k, m) for m in range(self.m)]

    def _client_tensor_parallel(self, params, batch: dict, k: int) -> tuple:
        """Client k's loss and autograd over its M ranks, each on its own
        shards (:func:`~repro_torch.models.model.loss_fn_tp`); rank (k, m)'s
        gradients are column m's pieces."""
        devs = self._devices(k)
        leaves = [[x.detach().requires_grad_(True) for x in tree_leaves(t)]
                  for t in self._rank_trees(params, k)]
        _, local = self._client_slice(batch, k)
        # one thread runs the backward of every device: the layer remat's
        # recompute is not safe from two devices' autograd threads at once
        with torch.enable_grad(), \
                torch.autograd.set_multithreading_enabled(False):
            loss, _ = model_mod.loss_fn_tp(
                self.cfg, [tree_unflatten(self.structure, lv)
                           for lv in leaves], local, TP(devs))
            grads = torch.autograd.grad(
                loss, [x for lv in leaves for x in lv], allow_unused=True)
        n = len(leaves[0])
        cols = []
        for m, dev in enumerate(devs):
            mine = []
            for j, plan in enumerate(self.layout.plans):
                # a replicated leaf's gradient is whole on rank (k, 0)
                g = grads[(0 if plan.model_dim is None else m) * n + j]
                if g is None:
                    raise ValueError(f"rank ({k}, {m}) made no gradient for "
                                     f"leaf {j}")
                mine.append(g)
            cols.append(self.layout.local_flatten(mine, m, self.agg_dt,
                                                  device=dev))
        return cols, loss.detach()

    def _client_batch_over_model(self, params, batch: dict, k: int
                                 ) -> tuple:
        """Client k's slice split into M sub-batches: rank (k, m) gathers
        the model-sharded leaves whole on its device and runs ``loss_fn`` +
        autograd on sub-batch m; column m sums every rank's column-m piece
        of each leaf (f32, fixed order, the mean's 1/M in each rank's
        backward). An MoE's load-balancing loss is a product of the
        client's means, so its M sub-batches run as one loss
        (:meth:`_moe_over_model`)."""
        devs = self._devices(k)
        per, local = self._client_slice(batch, k)
        sub = per // self.m
        if isinstance(params, RankShards):
            shards = [tree_leaves(t) for t in self._rank_trees(params, k)]

        def own_leaves(m, dev):
            if isinstance(params, RankShards):
                # the model-sharded leaves gathered whole (FSDP-style)
                own = [to_device(shards[m][j], dev)
                       if plan.model_dim is None else
                       torch.cat([to_device(c[j], dev) for c in shards],
                                 plan.model_dim)
                       for j, plan in enumerate(self.layout.plans)]
            else:
                own = [to_device(x, dev) for x in tree_leaves(params)]
            return [x.detach().requires_grad_(True) for x in own]

        def sub_batch(m, dev):
            return {name: to_device(v[m * sub:(m + 1) * sub], dev)
                    for name, v in local.items()}

        scale = 1.0 / self.m
        if self.cfg.family == "moe":
            grads, loss = self._moe_over_model(devs, own_leaves, sub_batch)
        else:
            grads, losses = [], []
            for m, dev in enumerate(devs):
                leaves = own_leaves(m, dev)
                with torch.enable_grad():
                    loss, _ = model_mod.loss_fn(
                        self.cfg, tree_unflatten(self.structure, leaves),
                        sub_batch(m, dev))
                    g = torch.autograd.grad(
                        loss, leaves,
                        grad_outputs=torch.full_like(loss, scale))
                grads.append(g)
                losses.append(loss.detach())
                del leaves
            loss = sum_to(losses, devs[0]) * scale
        cols = []
        for m, dev in enumerate(devs):
            parts = [sum_to([self.layout.piece(plan, g[j], m, g[j].dtype)
                             for g in grads], dev)
                     for j, plan in enumerate(self.layout.plans)]
            cols.append(self.layout.join([p.to(self.agg_dt) for p in parts],
                                         self.agg_dt))
        return cols, loss

    def _moe_over_model(self, devs: list, own_leaves, sub_batch) -> tuple:
        """An MoE client's M sub-batches as one loss: each rank's forward
        on its sub-batch gives its cross-entropy and each layer's
        ``[frac_tokens, frac_probs]``; the means over the ranks (f32,
        :func:`~repro_torch.models.tp.pair_sum`'s order, an autograd sum
        like ``TP.reduce``) give the client's cross-entropy and, per layer,
        the whole batch's fractions, so the aux is the reference's; one
        ``torch.autograd.grad`` over every rank's leaves → (each rank's
        gradients, the loss)."""
        tp = TP(devs)
        scale = 1.0 / self.m
        leaves = [own_leaves(m, dev) for m, dev in enumerate(devs)]
        # one thread runs the backward of every device (the layer remat's
        # recompute is not safe from two devices' autograd threads at once)
        with torch.enable_grad(), \
                torch.autograd.set_multithreading_enabled(False):
            ces, frs = [], []
            for m, dev in enumerate(devs):
                ce, fr = model_mod.loss_parts(
                    self.cfg, tree_unflatten(self.structure, leaves[m]),
                    sub_batch(m, dev))
                ces.append(ce)
                frs.append(fr)
            ce = tp.reduce(ces) * scale
            aux = model_mod.moe_aux(self.cfg, tp.reduce(frs) * scale)
            loss = ce + model_mod.MOE_AUX_WEIGHT * aux
            flat = [x for lv in leaves for x in lv]
            g = torch.autograd.grad(loss, flat)
        n = len(leaves[0])
        return [g[m * n:(m + 1) * n] for m in range(self.m)], loss.detach()

    def _mean_loss(self, losses: list) -> Tensor:
        total = to_device(losses[0], self.home).to(torch.float32)
        for loss in losses[1:]:
            total = total + to_device(loss, self.home).to(torch.float32)
        return total / self.k_dp

    # ---- phase 2: sparse incremental aggregation -----------------------
    def flatten_grads(self, grad_leaves: list, k: int) -> list:
        """Client k's gradient → its M column pieces ``[n_local]`` in
        ``agg_dtype``, column m on rank (k, m)'s device."""
        return [to_device(self.layout.local_flatten(grad_leaves, m,
                                                    self.agg_dt),
                          rank_device(self.mesh, k, m))
                for m in range(self.m)]

    def tcs_masks(self, params, prev) -> list:
        """Per column m, the TCS global mask ``|Δ_m| ≥ τ_G`` in
        ``agg_dtype`` (zero where the column's Δ is all zero), τ_G the
        sharded search over the M columns with counts from
        :func:`~repro_torch.kernels.ops.count_ge`."""
        acfg = self.agg_cfg
        p_trees, q_trees = self._rank_trees(params, 0), self._rank_trees(
            prev, 0)
        deltas = []
        for m, dev in enumerate(self._devices(0)):
            # column m's Δ on rank (0, m)'s device, from that rank's trees
            p_col = self.layout.local_flatten(tree_leaves(p_trees[m]), m,
                                              torch.float32, device=dev)
            q_col = self.layout.local_flatten(tree_leaves(q_trees[m]), m,
                                              torch.float32, device=dev)
            deltas.append(p_col - q_col)
            del p_col, q_col
        tau = sp.threshold_for_topq(
            deltas, self.qg_total, branch=acfg.hist_branch,
            rounds=acfg.hist_rounds, tau_impl=acfg.tau_impl,
            count_fn=kops.count_ge)
        masks = []
        for delta in deltas:
            t = to_device(tau, delta.device)
            keep = (delta.abs() >= t) & (delta != 0).any()
            masks.append(keep.to(self.agg_dt))
        return masks

    def aggregate(self, cols: list, ef, stage_ef, weights,
                  participate, masks: Optional[list] = None) -> tuple:
        """Phase 2. ``cols[k][m]``: rank (k, m)'s ``[n_local]`` column;
        ``ef [K_dp, d_flat]`` (or its rank pieces); ``weights``/
        ``participate`` K_dp values.

        → ``(agg [d_flat] f32, ef [K_dp, d_flat], stage_ef, RingStats
        summed over every rank, relay bits or None)``; for a placed ``ef``
        the aggregate, EF and stage EF come back as rank pieces, each on
        its rank's device (the aggregate's piece is the rank's owned
        segment).
        """
        from repro_torch.agg.device import (run_nested_segments_local,
                                            run_plan_segments_local)
        n, k_dp, m_cols = self.layout.n_local, self.k_dp, self.m
        seg = self.seg
        placed = isinstance(ef, RankPieces)
        if placed:
            agg_p, ef_p = [None] * (k_dp * m_cols), [None] * (k_dp * m_cols)
            se_p = [[None] * (k_dp * m_cols) for _ in stage_ef or ()]
        else:
            agg = torch.empty((self.layout.d_flat,), dtype=torch.float32,
                              device=self.home)
            ef_new = torch.empty_like(ef)
            se_new = (None if stage_ef is None else
                      tuple(torch.empty_like(e) for e in stage_ef))
        w = [float(x) for x in weights]
        p = [float(x) for x in participate]
        rank_stats, relay = [], []
        for m in range(m_cols):
            cmesh = self.col_meshes[m]
            devs = cmesh.devices
            flat = [cols[k][m] for k in range(k_dp)]
            if placed:
                ef_l = [ef.pieces[k * m_cols + m] for k in range(k_dp)]
            else:
                ef_l = [to_device(ef[k, m * n:(m + 1) * n], devs[k])
                        for k in range(k_dp)]
            gm = (None if masks is None else
                  [to_device(masks[m], devs[k]) for k in range(k_dp)])
            if self.nested is None:
                final, e_out, sts = run_plan_segments_local(
                    self.agg_cfg, self.plan, cmesh, flat, ef_l, w,
                    global_mask=gm, participate=p, transport="static")
            else:
                if placed:
                    se_l = [[e.pieces[k * m_cols + m] for k in range(k_dp)]
                            for e in stage_ef]
                else:
                    se_l = [[to_device(
                        e[k, m * (e.shape[1] // m_cols):
                          (m + 1) * (e.shape[1] // m_cols)], devs[k])
                        for k in range(k_dp)] for e in stage_ef]
                final, e_out, s_out, st_s = run_nested_segments_local(
                    self.agg_cfg, self.plan, cmesh, flat, ef_l, se_l, w,
                    sizes=self.sizes, global_mask=gm, participate=p)
                for t, tier in enumerate(s_out):
                    for k in range(k_dp):
                        if placed:
                            se_p[t][k * m_cols + m] = tier[k]
                        else:
                            width = se_new[t].shape[1] // m_cols
                            se_new[t][k, m * width:(m + 1) * width] = tier[k]
                sts = [ring_mod.RingStats(
                    bits=sum(st[k].bits for st in st_s),
                    nnz=sum(st[k].nnz for st in st_s),
                    err_sq=sum(st[k].err_sq for st in st_s))
                    for k in range(k_dp)]
                relay.append([st_s[-1][k].bits for k in range(k_dp)])
            for k in range(k_dp):
                if placed:
                    agg_p[k * m_cols + m] = final[k]
                    ef_p[k * m_cols + m] = e_out[k]
                else:
                    off = m * n + self.owned[k] * seg
                    agg[off:off + seg] = final[k]
                    ef_new[k, m * n:(m + 1) * n] = e_out[k]
            rank_stats.append(sts)
            del final, e_out, flat, ef_l
        if placed:
            agg = RankPieces(agg_p, self.flat_index, (self.layout.d_flat,))
            ef_new = RankPieces(ef_p, ef.index, ef.tail)
            se_new = (None if stage_ef is None else tuple(
                RankPieces(pieces, e.index, e.tail)
                for pieces, e in zip(se_p, stage_ef)))
        stats, relay_bits = self._sum_stats(rank_stats, relay)
        return agg, ef_new, se_new, stats, relay_bits

    def _sum_stats(self, rank_stats: list, relay: list) -> tuple:
        """Every rank's stats, rank order (k, m), summed pairwise on the
        first device → (RingStats, relay bits or None)."""
        order = _ranks(self.mesh)
        stacked = torch.stack([torch.stack([
            to_device(getattr(rank_stats[m][k], f), self.home).to(
                torch.float32) for f in ("bits", "nnz", "err_sq")])
            for k, m in order], -1)
        tot = _slot_sum(stacked)
        stats = ring_mod.RingStats(bits=tot[0], nnz=tot[1], err_sq=tot[2])
        relay_bits = None
        if relay:
            relay_bits = _slot_sum(torch.stack(
                [to_device(relay[m][k], self.home).to(torch.float32)
                 for k, m in order]))
        return stats, relay_bits

    # ---- phase 3: flat optimizer + downlink ----------------------------
    def update(self, state: TrainState, agg, weights,
               participate) -> tuple:
        """Phase 3 → ``(master, opt state, params, tcs_prev, lr_scale)``.
        A placed state updates piece by piece, each on its rank's device
        (``grad_clip``'s Σ g² summed over the pieces in rank order)."""
        tc = self.tc
        terms = (torch.tensor(weights, dtype=torch.float32)
                 * torch.tensor(participate, dtype=torch.float32))
        total = terms[0]
        for t in terms[1:]:
            total = total + t
        total_w = torch.clamp(total, min=1e-9).to(self.home)
        lr_scale = lr_schedule(state.step, warmup=tc.lr_warmup,
                               decay_steps=tc.lr_decay_steps)
        if not isinstance(agg, RankPieces):
            grad_est = agg.to(torch.float32) / total_w
            master, opt = opt_mod.apply_flat(tc.opt, state.opt, state.master,
                                             grad_est, lr_scale)
            del grad_est
        else:
            master, opt = self._update_pieces(state, agg, total_w, lr_scale)
        params = self.downlink(master)
        tcs_prev = state.tcs_prev
        if self.needs_tcs:
            tcs_prev = map_state(lambda x: x.to(self.agg_dt), state.params)
        return master, opt, params, tcs_prev, lr_scale

    def _update_pieces(self, state: TrainState, agg: RankPieces, total_w,
                       lr_scale) -> tuple:
        ocfg, opt = self.tc.opt, state.opt

        def grad(r):
            a = agg.pieces[r]
            return a.to(torch.float32) / to_device(total_w, a.device)

        sq = None
        if ocfg.grad_clip > 0:
            sq = _slot_sum(torch.stack([
                to_device(torch.sum(g * g), self.home)
                for g in map(grad, range(len(agg.pieces)))]))
        masters, ms, vs = [], [], []
        for r, p in enumerate(state.master.pieces):
            dev = p.device
            piece = opt_mod.FlatOptState(
                to_device(opt.step, dev),
                None if opt.m is None else opt.m.pieces[r],
                None if opt.v is None else opt.v.pieces[r])
            new_p, new_o = opt_mod.apply_flat(
                ocfg, piece, p, grad(r), lr_scale,
                sq_sum=None if sq is None else to_device(sq, dev))
            masters.append(new_p)
            ms.append(new_o.m)
            vs.append(new_o.v)
        master = RankPieces(masters, state.master.index, state.master.tail)
        new_opt = opt_mod.FlatOptState(
            opt.step + 1,
            None if opt.m is None else RankPieces(ms, opt.m.index,
                                                  opt.m.tail),
            None if opt.v is None else RankPieces(vs, opt.v.index,
                                                  opt.v.tail))
        return master, new_opt

    def downlink(self, master):
        """Flat master → param tree (the w^{t+1} broadcast): whole from a
        whole master; from rank pieces a
        :class:`~repro_torch.train.state.RankShards`, each (device, column
        m) tree rebuilt leaf by leaf from column m's K_dp master segments
        (a replicated leaf's other columns gathered over m), each part cast
        to the leaf's dtype where it lies and moved there — no device holds
        a whole f32 master."""
        if not isinstance(master, RankPieces):
            return tree_unflatten(self.structure,
                                  self.layout.unflatten(master))
        trees = [tree_unflatten(self.structure,
                                self._column_leaves(master, dev, m))
                 for dev, m in self.places]
        return RankShards([d for d, _ in self.places],
                          [m for _, m in self.places], trees,
                          [p.model_dim for p in self.layout.plans])

    def _flat_range(self, master: RankPieces, col: int, lo: int, size: int,
                    dtype, dev) -> Tensor:
        """Column ``col``'s flat entries ``[lo, lo + size)`` on ``dev`` in
        ``dtype``, from the segments of the ranks that own them."""
        seg, parts = self.seg, []
        for j in range(lo // seg, (lo + size - 1) // seg + 1):
            k = self.owned.index(j)
            a, b = max(lo, j * seg), min(lo + size, (j + 1) * seg)
            piece = master.pieces[k * self.m + col][a - j * seg:b - j * seg]
            parts.append(to_device(piece.to(dtype), dev))
        return torch.cat(parts)

    def _column_leaves(self, master: RankPieces, dev, m: int) -> list:
        out, off = [], 0
        for plan in self.layout.plans:
            size = plan.local_size
            if plan.model_dim is None:
                full = torch.cat([self._flat_range(master, c, off, size,
                                                   plan.dtype, dev)
                                  for c in range(self.m)])
                numel = math.prod(plan.global_shape)
                out.append(full[:numel].reshape(plan.global_shape))
            else:
                out.append(self._flat_range(master, m, off, size, plan.dtype,
                                            dev).reshape(plan.local_shape))
            off += size
        return out

    def _ef_telemetry(self, ef_new: RankPieces, se_new,
                      participate) -> tuple:
        """``(ef_mass, ef_dead_mass)`` over rank pieces: each piece's
        ‖·‖₁ in float32 on the first device, summed in rank order (a cohort
        axis leads)."""
        from repro_torch.runtime.fault import dead_banked_mass

        def rows(leaf):                      # [..., K_dp]
            per = [to_device(torch.sum(torch.abs(p).to(torch.float32),
                                       dim=-1), self.home)
                   for p in leaf.pieces]
            return torch.stack([_slot_sum(torch.stack(
                per[k * self.m:(k + 1) * self.m], -1))
                for k in range(self.k_dp)], -1)

        row = rows(ef_new)
        mass = _slot_sum(row)
        for se in se_new or ():
            mass = mass + _slot_sum(rows(se))
        part = to_device(torch.tensor(participate, dtype=torch.float32),
                         self.home).expand(row.shape)
        dead = dead_banked_mass(row.unsqueeze(-1), part)
        return mass.to(ef_new.dtype), dead.to(ef_new.dtype)

    # ---- the step -------------------------------------------------------
    def round_inputs(self, batch: dict) -> tuple:
        """``batch`` → (the model inputs, K_dp weights, K_dp participation
        flags as floats; defaults 1/K_dp and 1)."""
        batch = dict(batch)
        weights = batch.pop("weights", None)
        participate = batch.pop("participate", None)
        if weights is None:
            weights = [float(torch.tensor(1.0 / self.k_dp,
                                          dtype=torch.float32))] * self.k_dp
        if participate is None:
            participate = [1.0] * self.k_dp
        weights = [float(x) for x in torch.as_tensor(weights).reshape(-1)]
        participate = [float(x) for x in
                       torch.as_tensor(participate).reshape(-1)]
        return batch, weights, participate

    def __call__(self, state: TrainState, batch: dict) -> tuple:
        batch, weights, participate = self.round_inputs(batch)
        cols, loss = self.phase1(state, batch)
        return self.finish(state, cols, loss, weights, participate)

    def phase1(self, state: TrainState, batch: dict) -> tuple:
        """Phase 1, each client's gradient flattened as soon as it is made
        → ``(cols, loss)``: ``cols[k][m]`` is rank (k, m)'s column
        ``[n_local]`` (``[B, n_local]`` for cohorts, tenant-major) and
        ``loss`` the mean client loss (``[B]`` for cohorts)."""
        self._check_form(state)
        if self.cohorts == 1:
            cols, losses = [], []
            for k in range(self.k_dp):
                c, loss = self.client_cols(state.params, batch, k)
                cols.append(c)
                losses.append(loss)
                del c
            return cols, self._mean_loss(losses)
        per = [[[] for _ in range(self.m)] for _ in range(self.k_dp)]
        losses = []
        for i in range(self.cohorts):
            params_i = _cohort(state.params, i)
            batch_i = {name: v[i] for name, v in batch.items()}
            l_i = []
            for k in range(self.k_dp):
                c_k, loss = self.client_cols(params_i, batch_i, k)
                for m, c in enumerate(c_k):
                    per[k][m].append(c)
                l_i.append(loss)
                del c_k
            losses.append(self._mean_loss(l_i))
        cols = [[torch.stack(c) for c in row] for row in per]
        return cols, torch.stack(losses)

    def finish(self, state: TrainState, cols: list, loss: Tensor, weights,
               participate) -> tuple:
        """Phases 2 and 3 on the flattened per-client gradients
        (``cols[k]`` from :meth:`flatten_grads`, or :meth:`phase1`) →
        ``(state, metrics)``."""
        self._check_form(state)
        if self.cohorts > 1:
            return self._cohort_finish(state, cols, loss, weights,
                                       participate)
        masks = (self.tcs_masks(state.params, state.tcs_prev)
                 if self.needs_tcs else None)
        agg, ef_new, se_new, stats, relay_bits = self.aggregate(
            cols, state.ef, state.stage_ef, weights, participate, masks)
        del cols, masks
        master, opt, params, tcs_prev, lr_scale = self.update(
            state, agg, weights, participate)
        metrics = {"loss": loss, "agg_bits": stats.bits,
                   "agg_nnz": stats.nnz, "agg_err_sq": stats.err_sq,
                   "lr_scale": lr_scale}
        if relay_bits is not None:
            # the scarce-link tier (pod seam / inter-cluster relay)
            metrics["agg_bits_relay"] = relay_bits
        if self.telemetry and self.placed:
            metrics["ef_mass"], metrics["ef_dead_mass"] = \
                self._ef_telemetry(ef_new, se_new, participate)
        elif self.telemetry:
            from repro_torch.runtime.fault import dead_banked_mass
            mass = torch.sum(torch.abs(ef_new))
            for se in se_new or ():
                mass = mass + torch.sum(torch.abs(se))
            metrics["ef_mass"] = mass
            metrics["ef_dead_mass"] = dead_banked_mass(
                ef_new.reshape(self.k_dp, -1),
                torch.tensor(participate, dtype=torch.float32,
                             device=self.home))
        new_state = TrainState(step=state.step + 1, params=params,
                               master=master, opt=opt, ef=ef_new,
                               tcs_prev=tcs_prev, stage_ef=se_new)
        return new_state, metrics

    # ---- cohort-batched step (B tenants, one aggregation per column) ----
    def _cohort_finish(self, state: TrainState, cols: list, loss: Tensor,
                       weights, participate) -> tuple:
        from repro_torch.agg.device import run_plan_segments_batched
        b_coh, k_dp, n, seg = (self.cohorts, self.k_dp, self.layout.n_local,
                               self.seg)
        masks = ([self.tcs_masks(_cohort(state.params, i),
                                 _cohort(state.tcs_prev, i))
                  for i in range(b_coh)] if self.needs_tcs else [])
        # phase 2 — every tenant of a column in one batched round
        placed = self.placed
        if placed:
            agg_p, ef_p = [None] * (k_dp * self.m), [None] * (k_dp * self.m)
        else:
            agg = torch.empty((b_coh, self.layout.d_flat),
                              dtype=torch.float32, device=self.home)
            ef_new = torch.empty_like(state.ef)
        rank_stats = []
        for m in range(self.m):
            cmesh = self.col_meshes[m]
            devs = cmesh.devices
            flat = [cols[k][m] for k in range(k_dp)]
            if placed:
                ef_l = [state.ef.pieces[k * self.m + m] for k in range(k_dp)]
            else:
                ef_l = [to_device(state.ef[:, k, m * n:(m + 1) * n], devs[k])
                        for k in range(k_dp)]
            gm = (None if not masks else
                  [to_device(torch.stack([mk[m] for mk in masks]), devs[k])
                   for k in range(k_dp)])
            final, e_out, sts = run_plan_segments_batched(
                self.agg_cfg, self.plan, cmesh, flat, ef_l,
                [[weights[k]] * b_coh for k in range(k_dp)],
                global_mask=gm,
                participate=[[participate[k]] * b_coh for k in range(k_dp)],
                transport="static")
            for k in range(k_dp):
                if placed:
                    agg_p[k * self.m + m] = final[k]
                    ef_p[k * self.m + m] = e_out[k]
                else:
                    off = m * n + self.owned[k] * seg
                    agg[:, off:off + seg] = final[k]
                    ef_new[:, k, m * n:(m + 1) * n] = e_out[k]
            rank_stats.append(sts)
        if placed:
            agg = RankPieces(agg_p, self.flat_index, (self.layout.d_flat,))
            ef_new = RankPieces(ef_p, state.ef.index, state.ef.tail)
        tot, _ = self._sum_stats(rank_stats, [])           # each [B]
        # phase 3 — per tenant
        outs = [self.update(_cohort(state, i), _cohort(agg, i), weights,
                            participate)
                for i in range(b_coh)]
        master = _stack_states([o[0] for o in outs])
        opt = _stack_states([o[1] for o in outs])
        params = _stack_states([o[2] for o in outs])
        tcs_prev = (_stack_states([o[3] for o in outs]) if self.needs_tcs
                    else state.tcs_prev)
        lr_scale = torch.stack([o[4] for o in outs])
        metrics = {"loss": loss, "agg_bits": tot.bits,
                   "agg_nnz": tot.nnz, "agg_err_sq": tot.err_sq,
                   "lr_scale": lr_scale}
        if self.telemetry and placed:
            metrics["ef_mass"], metrics["ef_dead_mass"] = \
                self._ef_telemetry(ef_new, None, participate)
        elif self.telemetry:
            from repro_torch.runtime.fault import dead_banked_mass
            part = torch.tensor(participate, dtype=torch.float32,
                                device=self.home).expand(b_coh, k_dp)
            metrics["ef_mass"] = torch.sum(torch.abs(ef_new), dim=(1, 2))
            metrics["ef_dead_mass"] = dead_banked_mass(
                ef_new.reshape(b_coh, k_dp, -1), part)
        new_state = TrainState(step=state.step + 1, params=params,
                               master=master, opt=opt, ef=ef_new,
                               tcs_prev=tcs_prev, stage_ef=state.stage_ef)
        return new_state, metrics


def build_train_step(cfg: ModelConfig, tc: TrainConfig, mesh,
                     topology: Any = None, telemetry: bool = False,
                     cohorts: int = 1) -> TrainStep:
    """Returns ``train_step(state, batch) → (state, metrics)``.

    ``batch`` holds ``tokens``/``labels`` ``[global_batch, S]`` (and the
    frontend inputs), split over the K_dp clients in contiguous slices,
    plus optional ``weights`` and ``participate`` (K_dp values each).

    ``cohorts=B`` builds the multi-tenant step: ``state`` carries a leading
    cohort axis on every leaf (:func:`init_state` with the same
    ``cohorts``), ``batch`` leaves carry ``[B, global_batch, …]``; phase 1
    runs per tenant, phase 2 runs every tenant of a model column through
    one :func:`~repro_torch.agg.device.run_plan_segments_batched` round,
    phase 3 per tenant. Metrics come back per cohort (``[B]``). Flat
    topologies only; per cohort the math is the sequential step's.

    ``telemetry=True`` adds ``ef_mass`` (Σ_k ‖e_k‖₁ over every EF tier)
    and ``ef_dead_mass`` (:func:`repro_torch.runtime.fault.
    dead_banked_mass` over the round's non-participants).

    ``topology`` selects the aggregation route over the K_dp clients:
    ``None`` keeps the rotated ring (the paper chain); an
    :class:`~repro_torch.agg.AggPlan`, an ``AggTree``, a chain order, or a
    ``ConstellationGraph`` is compiled by :func:`repro_torch.agg.
    compile_plan` and lowered by ``run_plan_segments_local``. Nested
    topologies — ``"hierarchical"``, a :class:`~repro_torch.agg.nested.
    NestedPlan`, or a routed ``NestedTopology`` — lower through
    ``run_nested_segments_local``: stage 0 on the minor DP axis, later
    stages up the remaining axes, the upper EF tiers in
    ``state.stage_ef``; metrics gain ``agg_bits_relay``, the last stage's
    §V bits. Pass the same ``topology`` to :func:`init_state`.
    """
    return TrainStep(cfg, tc, mesh, topology=topology, telemetry=telemetry,
                     cohorts=cohorts)


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def _split(cfg: ModelConfig, mesh, params, cache):
    """The :class:`~repro_torch.models.serve_split.ServeSplit` of a
    serving call on a mesh of several ranks (``None`` on one rank, where
    the step runs whole as the reference's one-device program)."""
    from repro_torch.models import serve_split
    if not serve_split.is_split(mesh):
        return None
    if not isinstance(params, RankShards) or \
            not isinstance(cache, serve_split.RankCache):
        raise ValueError(
            "a mesh of several ranks serves placed params and cache "
            "(serve_split.place_params, serve_split.init_cache)")
    return serve_split.split_of(cfg, mesh, cache)


def build_serve_step(cfg: ModelConfig, mesh):
    """decode: (params, cache, token [B], pos) → (next_token [B], cache);
    the cache is consumed (updated in place). On a mesh of several ranks
    the params and cache are placed by rank and the step is split over
    them (:mod:`repro_torch.models.serve_split`)."""

    def serve_step(params, cache, token, pos):
        split = _split(cfg, mesh, params, cache)
        with torch.inference_mode():
            if split is None:
                logits, cache = model_mod.decode_step(cfg, params, cache,
                                                      token, int(pos))
            else:
                logits, cache = split.decode(params, cache, token, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step


def build_prefill_step(cfg: ModelConfig, mesh):
    """prefill: (params, cache, tokens [B, S], extra) → (next_token [B],
    cache), split over the ranks of a mesh of several (as
    :func:`build_serve_step`)."""

    def prefill_step(params, cache, tokens, extra=None):
        split = _split(cfg, mesh, params, cache)
        kw = {} if extra is None else dict(extra)
        with torch.inference_mode():
            if split is None:
                logits, cache = model_mod.prefill(cfg, params, tokens, cache,
                                                  **kw)
            else:
                logits, cache = split.prefill(params, cache, tokens, kw)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return prefill_step
