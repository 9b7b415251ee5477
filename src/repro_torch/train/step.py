"""The assembled train step (and serve steps); port of
:mod:`repro.train.step`.

The reference compiles one SPMD program over a (pod, data, model) mesh.
The port has one controller over a :class:`~repro_torch.launch.mesh.Mesh`
of local devices and runs the same three phases as named methods of
:class:`TrainStep`, so each can be held alone:

  1. :meth:`TrainStep.phase1` (the reference's ``per_client``; one client
     is :meth:`TrainStep.client_grad`) — per-client gradients: for each DP
     rank k, ``loss_fn`` + autograd on that rank's slice of the batch, on
     the device of rank (k, 0), with one params copy per distinct device.
     The model axis computes nothing of its own: the (k, m) ranks of one
     client share that client's gradient (the one-process counterpart of
     the reference's TP compute, with the same numbers). The reported loss
     is the mean of the per-client losses, summed in client order;
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
     :func:`apply_flat`), the downlink (flat master → param tree), and the
     TCS reference refresh.

The :class:`~repro_torch.train.state.TrainState` keeps the reference's
global layout: ``master [d_flat]``, ``ef [K_dp, d_flat]`` (row k, column
block m is rank (k, m)'s EF) and ``stage_ef``. Rank (k, m) owns segment
``_owned_segment(k)`` of column m — its DP rank for flat topologies, its
position in stage order (reversed DP axes) for nested ones. The global
vectors do not depend on that order; only the ownership does. The state
lives on the mesh's first device: where every rank shares one device
(``["cuda:0"] * K``, ``["cpu"] * K``) each rank's piece is a view of it,
and on a mesh of several devices each piece is copied to its rank's device
for the round and back. Placement is still decided by :func:`init_state`
(the whole state on the mesh's first device); :func:`state_shardings` gives
what each rank owns under the reference's program, as spec data.
"""

from __future__ import annotations

import dataclasses
import functools
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
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.optim import optimizers as opt_mod
from repro_torch.optim.schedule import lr_schedule
from repro_torch.train.state import (TrainConfig, TrainState,
                                    map_state)

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
    """Materializing init on the mesh's first device (params drawn from
    ``generator``, as :func:`repro_torch.models.model.init_params`).

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
    opt = opt_mod.init_flat(tc.opt, layout.d_flat, like=master)
    ef = torch.zeros((k_dp, layout.d_flat), dtype=_dtype(tc.ef_dtype),
                     device=home)
    stage_ef = None
    if nested is not None:
        stage_ef = tuple(
            torch.zeros((k_dp, dim), dtype=_dtype(tc.ef_dtype), device=home)
            for dim in _stage_ef_dims(mesh, n_axes, layout.d_flat))
    tcs_prev = None
    if tc.needs_tcs():
        tcs_prev = tree_map(lambda p: p.to(_dtype(tc.agg_dtype)), params)
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=home),
                      params=params, master=master, opt=opt, ef=ef,
                      tcs_prev=tcs_prev, stage_ef=stage_ef)


def _stack_states(states: list):
    """Stack a list of equal-structure states on a new leading axis."""
    first = states[0]
    if first is None:
        return None
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

    # ---- phase 1: per-client gradients ---------------------------------
    def _params_on(self, params, copies: dict, dev):
        if dev not in copies:
            copies[dev] = [to_device(p, dev) for p in tree_leaves(params)]
        return copies[dev]

    def client_grad(self, params, batch: dict, k: int,
                    copies: Optional[dict] = None) -> tuple:
        """Client k's ``(gradient leaves, loss)`` on its slice of the
        global batch, on the device of rank (k, 0)."""
        copies = {} if copies is None else copies
        dev = rank_device(self.mesh, k, 0)
        b = batch["tokens"].shape[0]
        if b % self.k_dp:
            raise ValueError(f"global batch {b} does not split over "
                             f"{self.k_dp} DP ranks")
        per = b // self.k_dp
        leaves = [p.detach().requires_grad_(True)
                  for p in self._params_on(params, copies, dev)]
        local = {name: to_device(v[k * per:(k + 1) * per], dev)
                 for name, v in batch.items()}
        with torch.enable_grad():
            loss, _ = model_mod.loss_fn(
                self.cfg, tree_unflatten(self.structure, leaves), local)
            grads = torch.autograd.grad(loss, leaves)
        return list(grads), loss.detach()

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
        deltas = []
        for m in range(self.m):
            dev = rank_device(self.mesh, 0, m)
            p_col = self.layout.local_flatten(tree_leaves(params), m,
                                              torch.float32)
            q_col = self.layout.local_flatten(tree_leaves(prev), m,
                                              torch.float32)
            deltas.append(to_device(p_col - q_col, dev))
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

    def aggregate(self, cols: list, ef: Tensor, stage_ef, weights,
                  participate, masks: Optional[list] = None) -> tuple:
        """Phase 2. ``cols[k][m]``: rank (k, m)'s ``[n_local]`` column;
        ``ef [K_dp, d_flat]``; ``weights``/``participate`` K_dp values.

        → ``(agg [d_flat] f32, ef [K_dp, d_flat], stage_ef, RingStats
        summed over every rank, relay bits or None)``.
        """
        from repro_torch.agg.device import (run_nested_segments_local,
                                            run_plan_segments_local)
        n, k_dp = self.layout.n_local, self.k_dp
        seg = self.seg
        agg = torch.empty((self.layout.d_flat,), dtype=torch.float32,
                          device=self.home)
        ef_new = torch.empty_like(ef)
        se_new = (None if stage_ef is None else
                  tuple(torch.empty_like(e) for e in stage_ef))
        w = [float(x) for x in weights]
        p = [float(x) for x in participate]
        rank_stats, relay = [], []
        for m in range(self.m):
            cmesh = self.col_meshes[m]
            devs = cmesh.devices
            flat = [cols[k][m] for k in range(k_dp)]
            ef_l = [to_device(ef[k, m * n:(m + 1) * n], devs[k])
                    for k in range(k_dp)]
            gm = (None if masks is None else
                  [to_device(masks[m], devs[k]) for k in range(k_dp)])
            if self.nested is None:
                final, e_out, sts = run_plan_segments_local(
                    self.agg_cfg, self.plan, cmesh, flat, ef_l, w,
                    global_mask=gm, participate=p, transport="static")
            else:
                se_l = [[to_device(e[k, m * (e.shape[1] // self.m):
                                     (m + 1) * (e.shape[1] // self.m)],
                                   devs[k]) for k in range(k_dp)]
                        for e in stage_ef]
                final, e_out, s_out, st_s = run_nested_segments_local(
                    self.agg_cfg, self.plan, cmesh, flat, ef_l, se_l, w,
                    sizes=self.sizes, global_mask=gm, participate=p)
                for e_dst, tier in zip(se_new, s_out):
                    width = e_dst.shape[1] // self.m
                    for k in range(k_dp):
                        e_dst[k, m * width:(m + 1) * width] = tier[k]
                sts = [ring_mod.RingStats(
                    bits=sum(st[k].bits for st in st_s),
                    nnz=sum(st[k].nnz for st in st_s),
                    err_sq=sum(st[k].err_sq for st in st_s))
                    for k in range(k_dp)]
                relay.append([st_s[-1][k].bits for k in range(k_dp)])
            for k in range(k_dp):
                off = m * n + self.owned[k] * seg
                agg[off:off + seg] = final[k]
                ef_new[k, m * n:(m + 1) * n] = e_out[k]
            rank_stats.append(sts)
            del final, e_out, flat, ef_l
        # every rank's stats, rank order (k, m), summed pairwise
        order = [(k, m) for k in range(k_dp) for m in range(self.m)]
        stacked = torch.stack([torch.stack([
            to_device(rank_stats[m][k].bits, self.home).to(torch.float32),
            to_device(rank_stats[m][k].nnz, self.home).to(torch.float32),
            to_device(rank_stats[m][k].err_sq, self.home).to(torch.float32)])
            for k, m in order], -1)
        tot = _slot_sum(stacked)
        stats = ring_mod.RingStats(bits=tot[0], nnz=tot[1], err_sq=tot[2])
        relay_bits = None
        if relay:
            relay_bits = _slot_sum(torch.stack(
                [to_device(relay[m][k], self.home).to(torch.float32)
                 for k, m in order]))
        return agg, ef_new, se_new, stats, relay_bits

    # ---- phase 3: flat optimizer + downlink ----------------------------
    def update(self, state: TrainState, agg: Tensor, weights,
               participate) -> tuple:
        """Phase 3 → ``(master, opt state, params, tcs_prev, lr_scale)``."""
        tc = self.tc
        terms = (torch.tensor(weights, dtype=torch.float32)
                 * torch.tensor(participate, dtype=torch.float32))
        total = terms[0]
        for t in terms[1:]:
            total = total + t
        total_w = torch.clamp(total, min=1e-9).to(self.home)
        grad_est = agg.to(torch.float32) / total_w
        lr_scale = lr_schedule(state.step, warmup=tc.lr_warmup,
                               decay_steps=tc.lr_decay_steps)
        master, opt = opt_mod.apply_flat(tc.opt, state.opt, state.master,
                                         grad_est, lr_scale)
        del grad_est
        params = self.downlink(master)
        tcs_prev = state.tcs_prev
        if self.needs_tcs:
            tcs_prev = tree_map(lambda x: x.to(self.agg_dt), state.params)
        return master, opt, params, tcs_prev, lr_scale

    def downlink(self, master: Tensor):
        """Flat master → param tree (the w^{t+1} broadcast)."""
        return tree_unflatten(self.structure,
                              self.layout.unflatten(master))

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
        if self.cohorts == 1:
            copies: dict = {}
            cols, losses = [], []
            for k in range(self.k_dp):
                g, loss = self.client_grad(state.params, batch, k, copies)
                cols.append(self.flatten_grads(g, k))
                losses.append(loss)
                del g
            return cols, self._mean_loss(losses)
        per = [[[] for _ in range(self.m)] for _ in range(self.k_dp)]
        losses = []
        for i in range(self.cohorts):
            params_i = _cohort(state.params, i)
            batch_i = {name: v[i] for name, v in batch.items()}
            copies = {}
            l_i = []
            for k in range(self.k_dp):
                g, loss = self.client_grad(params_i, batch_i, k, copies)
                for m, c in enumerate(self.flatten_grads(g, k)):
                    per[k][m].append(c)
                l_i.append(loss)
                del g
            losses.append(self._mean_loss(l_i))
        cols = [[torch.stack(c) for c in row] for row in per]
        return cols, torch.stack(losses)

    def finish(self, state: TrainState, cols: list, loss: Tensor, weights,
               participate) -> tuple:
        """Phases 2 and 3 on the flattened per-client gradients
        (``cols[k]`` from :meth:`flatten_grads`, or :meth:`phase1`) →
        ``(state, metrics)``."""
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
        if self.telemetry:
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
        agg = torch.empty((b_coh, self.layout.d_flat), dtype=torch.float32,
                          device=self.home)
        ef_new = torch.empty_like(state.ef)
        rank_stats = []
        for m in range(self.m):
            cmesh = self.col_meshes[m]
            devs = cmesh.devices
            flat = [cols[k][m] for k in range(k_dp)]
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
                off = m * n + self.owned[k] * seg
                agg[:, off:off + seg] = final[k]
                ef_new[:, k, m * n:(m + 1) * n] = e_out[k]
            rank_stats.append(sts)
        order = [(k, m) for k in range(k_dp) for m in range(self.m)]
        stacked = torch.stack([torch.stack([
            to_device(getattr(rank_stats[m][k], f), self.home).to(
                torch.float32) for f in ("bits", "nnz", "err_sq")])
            for k, m in order], -1)
        tot = _slot_sum(stacked)                            # [3, B]
        # phase 3 — per tenant
        outs = [self.update(_cohort(state, i), agg[i], weights, participate)
                for i in range(b_coh)]
        master = torch.stack([o[0] for o in outs])
        opt = _stack_states([o[1] for o in outs])
        params = _stack_states([o[2] for o in outs])
        tcs_prev = (_stack_states([o[3] for o in outs]) if self.needs_tcs
                    else state.tcs_prev)
        lr_scale = torch.stack([o[4] for o in outs])
        metrics = {"loss": loss, "agg_bits": tot[0],
                   "agg_nnz": tot[1], "agg_err_sq": tot[2],
                   "lr_scale": lr_scale}
        if self.telemetry:
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

def build_serve_step(cfg: ModelConfig, mesh):
    """decode: (params, cache, token [B], pos) → (next_token [B], cache);
    the cache is consumed (updated in place)."""

    def serve_step(params, cache, token, pos):
        with torch.inference_mode():
            logits, cache = model_mod.decode_step(cfg, params, cache, token,
                                                  int(pos))
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step


def build_prefill_step(cfg: ModelConfig, mesh):
    def prefill_step(params, cache, tokens, extra=None):
        kw = {} if extra is None else dict(extra)
        with torch.inference_mode():
            logits, cache = model_mod.prefill(cfg, params, tokens, cache,
                                              **kw)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return prefill_step
