"""Device-plan execution (port of :mod:`repro.agg.device`): any
:class:`~repro_torch.agg.plan.AggPlan` — chain, permuted order, routed
tree, one step of a :class:`~repro_torch.agg.schedule.TopologySchedule`, a
stage of a :class:`~repro_torch.agg.nested.NestedPlan` — runs over a
:class:`ClientMesh` of ranks, each on ``mesh.devices[r]``. Two lowerings:

``run_plan_clients_local`` / ``execute_sharded``
    Client per rank: rank r is client r, and its gradient, error-feedback
    row, inbox and node-step outputs stay on its device. One round is
    level-synchronous and bit-exact to the host executors
    (:func:`~repro_torch.agg.plan.execute`, ``execute_batched``,
    :func:`~repro_torch.agg.nested.execute_nested`): the same aggregate,
    EF rows and per-client §V :class:`~repro_torch.core.algorithms.
    HopStats`. This is the backend behind ``Simulator(backend="device")``.

``run_plan_segments_local`` (and ``_batched``, ``run_nested_segments_local``)
    The rotated segments: rank r holds its flat vector split into K
    segments; segment s runs the plan with every position relabelled by
    ``+s (mod K)``, and after the round rank r owns the aggregate of
    segment r. On :func:`ring_chain_plan` this is the rotated ring
    (:mod:`repro_torch.core.ring`), and the chain×chain nested plan is the
    hierarchical ring (:mod:`repro_torch.core.hierarchical`).

The reference lowers the plan into one SPMD ``shard_map`` body over a mesh
of ``jax.devices()`` (faked on the CPU with
``--xla_force_host_platform_device_count``). The port has one controller
that holds the plan's numpy arrays and loops over the ranks — or, for the
segments, runs each level as one level step per distinct device with the
lanes of all its ranks (the lanes are independent, so each is bit for bit
the rank's own step):

* the client path runs only the ranks that hold a real slot of a level,
  one W = 1 fused level step each (lanes = B in the cohort form) — the
  reference runs the node step on every rank at every level and keeps the
  active results with a select;
* each slot's γ goes point to point, ``tensor.to(mesh.devices[parent])``
  — a peer copy between cards (asynchronous), a synchronous copy between
  a card and the CPU, nothing where both ranks share a device — and is
  added into the receiving inbox row, one add per real slot in slot order
  (never ``index_add_``, whose CUDA order is not fixed). A γ bound for a
  sink goes to the one copy of the sink rows on the caller's device. The
  reference all-gathers (clients) or ``ppermute``s (segments) every
  payload and scatter-adds;
* the compact ``(values[q], indices[q])`` wire of the CL algorithms is
  taken where :func:`_use_compact` allows it, as in the reference. The
  port's plans are always host arrays (the reference's ``_is_static_plan``
  is always true), so ``wire="auto"`` may pick the compact wire where the
  reference's jitted simulator, with a traced plan, sends dense; both give
  the same values.

A mesh may name one device several times (``client_mesh(28,
devices=["cuda:0"] * 28)`` on one card, ``["cpu"] * 8`` in the tests) —
the counterpart of the reference's fake host devices.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.agg.nested import NestedPlan, NestedResult, zero_stage_ef
from repro_torch.agg.plan import AggPlan, RoundResult, compile_plan
from repro_torch.core import sparsify as sp
from repro_torch.core.algorithms import (AggConfig, AggKind, HopStats,
                                         level_step, level_step_batched)
from repro_torch.core.ring import RingStats
from repro_torch.device import resolve_device, to_device
from repro_torch.topo.tree import PS, AggTree

Tensor = torch.Tensor

# Algorithms whose per-hop payload is bounded by the budget → eligible for
# the compact (values, indices) wire, the paper's ω + ⌈log₂ d⌉ format.
_COMPACT_KINDS = (AggKind.CL_SIA, AggKind.CL_TC_SIA)
_WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _wire_budget(cfg: AggConfig) -> int:
    if cfg.kind == AggKind.CL_TC_SIA:
        return cfg.q_global + cfg.q_local
    return cfg.q


def _compact_eligible(cfg: AggConfig, seg: int, budgeted: bool) -> bool:
    """Wire-format eligibility: the CL bound ‖γ‖₀ ≤ q that sizes the q
    compact slots holds only for the exact Top-Q sparsifier with a static
    budget (threshold Top-Q and dynamic budgets over-select on ties)."""
    q = _wire_budget(cfg)
    return (cfg.kind in _COMPACT_KINDS and not budgeted
            and cfg.topq_impl == "exact" and q < seg // 2)


def _use_compact(cfg: AggConfig, seg: int, plan: AggPlan,
                 participate_present: bool, wire: str) -> bool:
    """Decide the wire format for one round.

    Compact needs ‖γ‖₀ ≤ q on *every* hop. A non-participating (or
    stranded-stub) node forwards its incoming γ unchanged; on a tree that
    γ is a sum over children and can exceed q. Chains are safe for any
    straggler set; other plans only when every node transmits (no
    ``participate`` mask, all alive). ``wire="compact"`` lets a caller
    with that knowledge assert it; ``"dense"`` forces the dense payload.
    """
    if wire == "dense":
        return False
    eligible = _compact_eligible(cfg, seg, plan.q_budget is not None)
    if wire == "compact":
        if (cfg.kind not in _COMPACT_KINDS or plan.q_budget is not None
                or cfg.topq_impl != "exact"):
            raise ValueError(
                f"wire='compact' needs a constant-length algorithm with the "
                f"exact Top-Q sparsifier and no dynamic budgets; got "
                f"{cfg.kind} (topq_impl={cfg.topq_impl!r}, "
                f"q_budget={'set' if plan.q_budget is not None else 'none'})")
        return eligible
    if wire != "auto":
        raise ValueError(f"unknown wire format {wire!r}")
    if not eligible:
        return False
    k = plan.num_clients
    par = np.asarray(plan.parent_row)
    internal = par[(np.asarray(plan.slot_mask) > 0) & (par < k)]
    chain_like = (internal.size == 0
                  or np.bincount(internal, minlength=k).max() <= 1)
    all_alive = bool(np.all(np.asarray(plan.alive) > 0))
    return chain_like or (not participate_present and all_alive)


def _wire_format(cfg: AggConfig, d: int, plan: AggPlan,
                 participate_present: bool, wire: str) -> str:
    """``"compact"`` or ``"dense"``: ``"auto"`` never picks a quantizing
    wire (a bf16 ``wire_dtype`` would break host parity); ``"compact"``
    may."""
    use = _use_compact(cfg, d, plan, participate_present, wire)
    if use and (wire == "compact" or cfg.wire_dtype == "float32"):
        return "compact"
    return "dense"


def _send(cfg: AggConfig, payload: Tensor, dst: torch.device,
          compact: bool) -> Tensor:
    """One hop: ``payload`` (``[d]`` or ``[B, d]``) delivered on ``dst``.

    Dense: the tensor itself, copied to ``dst`` (no copy on its own
    device). Compact: the sender keeps ``(values[q], indices[q])`` per row
    (values in ``cfg.wire_dtype``), those travel, and the receiver
    scatters them back into zeros of the payload's dtype.
    """
    if not compact:
        return to_device(payload, dst)
    d = payload.shape[-1]
    vals, idx, _ = sp.compact(payload, _wire_budget(cfg))
    vals = to_device(vals.to(_WIRE_DTYPES[cfg.wire_dtype]), dst)
    return sp.scatter(vals.to(payload.dtype), to_device(idx, dst), d)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

def _canonical(dev) -> torch.device:
    """A device with its index: ``cuda`` → ``cuda:<current>``; raises for a
    CUDA device when there is no card."""
    dev = resolve_device(dev)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"{dev} named, but only "
                             f"{torch.cuda.device_count()} CUDA device(s) "
                             f"are visible")
    return dev


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """One device per rank: rank r (client r) lives on ``devices[r]``.
    A device may repeat — several ranks then share it and their transfers
    are no copies."""

    devices: tuple

    def __post_init__(self):
        object.__setattr__(self, "devices",
                           tuple(_canonical(d) for d in self.devices))
        if not self.devices:
            raise ValueError("a client mesh needs at least one rank")

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> tuple:
        """The mesh's devices in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))


def client_mesh(num_clients: int, devices: Optional[Sequence] = None
                ) -> ClientMesh:
    """The mesh of ``num_clients`` ranks.

    ``devices=None`` takes the first K visible CUDA devices and raises when
    there are fewer (or no card at all — it never takes the CPU). An
    explicit list names each rank's device and may repeat one, e.g.
    ``["cuda:0"] * K`` on one card or ``["cpu"] * K``.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"the device backend needs {num_clients} CUDA devices and "
                f"no CUDA device is available; pass devices=['cpu'] * "
                f"{num_clients} to run it on the CPU")
        have = torch.cuda.device_count()
        if have < num_clients:
            raise ValueError(
                f"device plan needs {num_clients} devices, have {have} "
                f"(pass devices=['cuda:0'] * {num_clients} to put several "
                f"ranks on one card — the counterpart of the reference's "
                f"--xla_force_host_platform_device_count)")
        devices = [torch.device("cuda", i) for i in range(num_clients)]
    devices = tuple(devices)
    if len(devices) != num_clients:
        raise ValueError(f"client mesh of {num_clients} ranks given "
                         f"{len(devices)} devices")
    return ClientMesh(devices=devices)


def _mesh_for(mesh: Optional[ClientMesh], k: int) -> ClientMesh:
    mesh = client_mesh(k) if mesh is None else mesh
    if mesh.size != k:
        raise ValueError(f"plan has {k} clients but the mesh has "
                         f"{mesh.size} ranks")
    return mesh


class _Ranks:
    """Per-device copies of round constants and per-rank row views.

    ``rows(x)`` splits a ``[K, ...]`` tensor into rank r's row on
    ``devices[r]``: one copy of the whole tensor per distinct device, then
    views, so a mesh on one card costs no copy at all.
    """

    def __init__(self, mesh: ClientMesh):
        self.mesh = mesh

    def on_each(self, x: Optional[Tensor]) -> dict:
        if x is None:
            return {dev: None for dev in self.mesh.distinct()}
        return {dev: to_device(x, dev) for dev in self.mesh.distinct()}

    def rows(self, x: Optional[Tensor]) -> list:
        """Rank r's row of ``x`` [K, ...] on ``devices[r]``."""
        if x is None:
            return [None] * self.mesh.size
        per = self.on_each(x)
        return [per[dev][r] for r, dev in enumerate(self.mesh.devices)]

    def zero_rows(self, shape: tuple, dtype) -> list:
        """A zeroed ``shape`` buffer per rank: one block per device."""
        devs = self.mesh.devices
        count = {dev: devs.count(dev) for dev in self.mesh.distinct()}
        block = {dev: torch.zeros((n,) + shape, dtype=dtype, device=dev)
                 for dev, n in count.items()}
        seen = dict.fromkeys(count, 0)
        out = []
        for dev in devs:
            out.append(block[dev][seen[dev]])
            seen[dev] += 1
        return out


def _zero_stats(lanes: int, device) -> HopStats:
    zi = torch.zeros((lanes,), dtype=torch.int32, device=device)
    zf = torch.zeros((lanes,), dtype=torch.float32, device=device)
    return HopStats(nnz_out=zi, nnz_global=zi, nnz_local=zi, bits=zf,
                    err_sq=zf)


def _gather_rows(rows: list, out_device, dim: int = 0) -> Tensor:
    """Stack per-rank rows on ``out_device``, in the rows' promoted dtype
    (a rank that never stepped keeps its input dtype)."""
    dtype = functools.reduce(torch.promote_types, [r.dtype for r in rows])
    return torch.stack([to_device(r, out_device).to(dtype) for r in rows],
                       dim=dim)


def _gather_stats(stats: list, out_device, dim: int = 0) -> HopStats:
    return HopStats(*(torch.cat([to_device(s[f], out_device) for s in stats],
                                dim=dim)
                      for f in range(len(HopStats._fields))))


# ---------------------------------------------------------------------------
# Client-per-rank rounds, B cohorts per rank (bit-exact to host execute)
# ---------------------------------------------------------------------------

def run_plan_clients_batched(
    cfg: AggConfig,
    plan: AggPlan,
    mesh: ClientMesh,
    g: list,                          # per rank: [B, d] on devices[r]
    e: list,                          # per rank: [B, d] EF rows
    weight: list,                     # per rank: [B] D_k per cohort
    participate: list,                # per rank: [B] participate·alive
    global_mask: dict,                # device → [B, d] per-cohort masks
    q_budget: list,                   # per rank: [B] int32, or Nones
    *,
    out_device: torch.device,
    wire: str = "dense",
) -> tuple:
    """Execute an AggPlan for B cohorts with client k living on rank k
    (paper mapping); :func:`run_plan_clients_local` is its B = 1 case.

    The reference's body runs inside ``shard_map``, once per rank; the
    port's single controller loops over the ranks instead. Levels run in
    order; no rank without a real slot at a level runs anything there.
    ``plan.num_clients`` must equal the mesh size (a stage plan is first
    padded by :func:`_pad_plan_clients`; its extra ranks never step).

    ``plan`` is shared ``[L, W]`` or stacked ``[B, L, W]``
    (:func:`~repro_torch.agg.plan.stack_plans`). At each level every rank
    that holds a real slot in any cohort runs ONE level step with lanes = B
    on its ``[B, d]`` rows and the per-lane ``[B, d]`` TCS mask; the lanes
    of cohorts where it holds no slot at that level (stacked plans) are
    invalid, and keep their EF rows and stats, as the reference's select
    does. A slot's γ travels to the rank playing its parent — or to the
    sink rows on ``out_device`` — and is added there, in slot order, one
    add per slot (per cohort where the cohorts' pairs differ), as host
    :func:`~repro_torch.agg.plan.execute` adds it. Returns the sink rows
    ``[B, d]`` (``[B, R, d]``, sink-ordered, for a forest plan) on
    ``out_device``, per-rank ``[B, d]`` EF rows and per-rank HopStats with
    ``[B]`` leaves; a rank that never steps keeps its EF rows and zero
    stats.
    """
    k = mesh.size
    if plan.num_clients != k:
        raise ValueError(f"plan has {plan.num_clients} clients but the mesh "
                         f"has {k} ranks")
    b, d = g[0].shape
    dt = g[0].dtype
    devs = mesh.devices
    node = np.asarray(plan.node_id)
    node = np.broadcast_to(node, (b,) + node.shape[-2:])
    parent = np.broadcast_to(np.asarray(plan.parent_row), node.shape)
    real = np.broadcast_to(np.asarray(plan.slot_mask) > 0, node.shape)
    compact = wire == "compact"
    lvl = level_step_batched(cfg)
    ranks = _Ranks(mesh)
    inbox = ranks.zero_rows((b, d), dt)
    valid_of: dict = {}             # (device, lane pattern) → [B, 1]

    def valid(dev, pattern):
        key = (dev, pattern)
        if key not in valid_of:
            valid_of[key] = torch.tensor(pattern, dtype=torch.float32,
                                         device=dev)[:, None]
        return valid_of[key]

    r_sinks = plan.num_sinks
    sinks = torch.zeros((b, r_sinks, d), dtype=dt, device=out_device)
    e_cur = list(e)
    zero = {dev: _zero_stats(b, dev) for dev in mesh.distinct()}
    stats = [zero[dev] for dev in devs]
    col = lambda x: None if x is None else x[:, None]  # noqa: E731

    for li in range(node.shape[1]):
        # one step per active rank, lanes = the cohorts where it is real
        active: dict = {}
        for wi in range(node.shape[2]):
            for c in np.flatnonzero(real[:, li, wi]):
                active.setdefault(int(node[c, li, wi]), set()).add(int(c))
        gout = {}
        for r, cohorts in active.items():
            dev = devs[r]
            pattern = tuple(float(c in cohorts) for c in range(b))
            out, e_new, st = lvl(
                g[r][:, None], inbox[r][:, None], e_cur[r][:, None],
                col(weight[r]), col(participate[r]), global_mask[dev],
                col(q_budget[r]), valid(dev, pattern))
            e_new, st = e_new[:, 0], HopStats(*(x[:, 0] for x in st))
            if len(cohorts) == b:
                e_cur[r], stats[r] = e_new, st
            else:
                keep = valid(dev, pattern)[:, 0] > 0
                e_cur[r] = torch.where(keep[:, None], e_new, e_cur[r])
                stats[r] = HopStats(*(torch.where(keep, s, a)
                                      for s, a in zip(st, stats[r])))
            gout[r] = out[:, 0]
        # deliveries in slot order; cohorts sharing a (sender, parent) pair
        # at a slot go in one add
        for wi in range(node.shape[2]):
            pairs: dict = {}
            for c in np.flatnonzero(real[:, li, wi]):
                pairs.setdefault((int(node[c, li, wi]),
                                  int(parent[c, li, wi])), []).append(int(c))
            for (r, p), cohorts in pairs.items():
                dst = devs[p] if p < k else out_device
                if len(cohorts) == b:
                    into = inbox[p] if p < k else sinks[:, p - k]
                    into.add_(_send(cfg, gout[r], dst, compact))
                    continue
                for c in cohorts:
                    into = inbox[p][c] if p < k else sinks[c, p - k]
                    into.add_(_send(cfg, gout[r][c], dst, compact))
    agg = sinks[:, 0] if r_sinks == 1 else sinks
    return agg, e_cur, stats


def execute_sharded_batched(
    cfg: AggConfig,
    plan: AggPlan,
    grads: Tensor,                 # [B, K, d] per-cohort client gradients
    e: Tensor,                     # [B, K, d] EF memories
    weights: Tensor,               # [B, K]
    *,
    mesh: Optional[ClientMesh] = None,
    global_mask: Optional[Tensor] = None,   # [B, d]
    participate: Optional[Tensor] = None,   # [B, K]
    wire: str = "auto",
) -> RoundResult:
    """B cohort rounds on a client mesh — the device twin of
    :func:`~repro_torch.agg.plan.execute_batched`.

    Clients go one per rank as in :func:`execute_sharded`; the cohort axis
    stays on each rank, so a level costs one step per active rank however
    many tenants ride it. Per cohort, bit for bit ``execute_sharded`` (and
    the host executors) on that cohort's inputs. The result's leaves carry
    the cohort axis first, on ``grads.device``.
    """
    b, k, d = grads.shape
    if plan.num_clients != k:
        raise ValueError(f"plan has {plan.num_clients} clients, grads {k}")
    if np.ndim(plan.node_id) == 3 and plan.node_id.shape[0] != b:
        raise ValueError(f"stacked plan has {plan.node_id.shape[0]} "
                         f"cohorts, grads {b}")
    mesh = _mesh_for(mesh, k)
    out, dt = grads.device, grads.dtype
    wire_fmt = _wire_format(cfg, d, plan, participate is not None, wire)
    if global_mask is None:
        global_mask = torch.zeros((b, d), dtype=dt, device=out)
    if participate is None:
        participate = torch.ones((b, k), dtype=dt, device=out)
    p_eff = participate * torch.as_tensor(plan.alive, dtype=dt, device=out)
    qb = None
    if plan.q_budget is not None:
        qb = torch.broadcast_to(torch.as_tensor(
            np.asarray(plan.q_budget), dtype=torch.int32, device=out), (b, k))

    def by_rank(x):                # [B, K, ...] → rank-major, contiguous
        return None if x is None else x.transpose(0, 1).contiguous()

    ranks = _Ranks(mesh)
    agg, e_rows, stats = run_plan_clients_batched(
        cfg, plan, mesh, ranks.rows(by_rank(grads)), ranks.rows(by_rank(e)),
        ranks.rows(by_rank(weights)), ranks.rows(by_rank(p_eff)),
        ranks.on_each(global_mask), ranks.rows(by_rank(qb)),
        out_device=out, wire=wire_fmt)
    return RoundResult(aggregate=agg, e_new=_gather_rows(e_rows, out, dim=1),
                       stats=_gather_stats([HopStats(*(s[:, None] for s in st))
                                            for st in stats], out, dim=1))


def run_plan_clients_local(
    cfg: AggConfig,
    plan: AggPlan,
    mesh: ClientMesh,
    g: list,                          # per rank: [d] on devices[r]
    e: list,                          # per rank: [d] EF row on devices[r]
    weight: list,                     # per rank: [1] D_k on devices[r]
    participate: list,                # per rank: [1] participate·alive
    global_mask: dict,                # device → [d] TCS mask
    q_budget: list,                   # per rank: [1] int32, or Nones
    *,
    out_device: torch.device,
    wire: str = "dense",              # "compact" | "dense" (resolved)
) -> tuple:
    """Execute an AggPlan with client k living on rank k (paper mapping):
    :func:`run_plan_clients_batched` with one cohort. Each rank holding a
    real slot at a level runs one W = 1 level step there.

    Returns ``(sink rows on out_device — [d], or [R, d] sink-ordered for a
    forest plan; per-rank EF rows; per-rank HopStats with [1] leaves)``.
    """
    agg, e_rows, stats = run_plan_clients_batched(
        cfg, plan, mesh, [x[None] for x in g], [x[None] for x in e], weight,
        participate, {dev: m[None] for dev, m in global_mask.items()},
        q_budget, out_device=out_device, wire=wire)
    return agg[0], [x[0] for x in e_rows], stats


def execute_sharded(
    cfg: AggConfig,
    plan: AggPlan,
    grads: Tensor,                 # [K, d] per-client effective gradients
    e: Tensor,                     # [K, d] EF memory
    weights: Tensor,               # [K]    D_k
    *,
    mesh: Optional[ClientMesh] = None,
    global_mask: Optional[Tensor] = None,
    participate: Optional[Tensor] = None,
    wire: str = "auto",
) -> RoundResult:
    """One aggregation round on a client mesh — drop-in for host
    :func:`~repro_torch.agg.plan.execute`.

    :func:`execute_sharded_batched` with one cohort: rank r takes client
    r's rows, and the result comes back on the caller's device
    (``grads.device``) with the :class:`~repro_torch.agg.plan.RoundResult`
    contract: ``aggregate`` ``[d]`` (``[R, d]`` for forest plans),
    ``e_new`` ``[K, d]``, per-client ``HopStats`` ``[K]`` — bit for bit the
    host executor's. ``mesh=None`` is :func:`client_mesh` over K CUDA
    devices.
    """
    one = lambda x: None if x is None else x[None]  # noqa: E731
    res = execute_sharded_batched(
        cfg, plan, grads[None], e[None], weights[None], mesh=mesh,
        global_mask=one(global_mask), participate=one(participate),
        wire=wire)
    return RoundResult(aggregate=res.aggregate[0], e_new=res.e_new[0],
                       stats=HopStats(*(x[0] for x in res.stats)))


# ---------------------------------------------------------------------------
# Nested (staged) plans on the client mesh
# ---------------------------------------------------------------------------

def _pad_plan_clients(plan: AggPlan, k_new: int) -> AggPlan:
    """Grow a stage plan's client count to the mesh size: the added clients
    never appear in the level schedule (their ranks never step); only the
    dummy, sink and trash row ids shift."""
    k = plan.num_clients
    if k == k_new:
        return plan
    if k > k_new:
        raise ValueError(f"cannot shrink a plan from {k} to {k_new} clients")
    shift = k_new - k
    node_id = np.asarray(plan.node_id)
    parent = np.asarray(plan.parent_row)

    def pad1(a, v, dt):
        return np.concatenate([np.asarray(a, dt), np.full((shift,), v, dt)])

    return AggPlan(
        node_id=np.where(node_id == k, k_new, node_id).astype(np.int32),
        slot_mask=np.asarray(plan.slot_mask),
        parent_row=np.where(parent >= k, parent + shift,
                            parent).astype(np.int32),
        flat_pos=pad1(plan.flat_pos, 0, np.int32),
        alive=pad1(plan.alive, 1.0, np.float32),
        q_budget=(None if plan.q_budget is None
                  else pad1(plan.q_budget, 0, np.int32)),
        num_clients=k_new, num_sinks=plan.num_sinks)


def _pad_rows(x: Tensor, k: int) -> Tensor:
    if x.shape[0] == k:
        return x
    return torch.cat([x, x.new_zeros((k - x.shape[0],) + x.shape[1:])])


def execute_nested_sharded(
    cfg: AggConfig,
    nested: NestedPlan,
    grads: Tensor,                 # [K, d] per-client effective gradients
    e: Tensor,                     # [K, d] client-tier EF memory
    weights: Tensor,               # [K]    D_k
    *,
    mesh: Optional[ClientMesh] = None,
    stage_e: Optional[Sequence[Tensor]] = None,   # EF tiers, [K_s, d]
    global_mask: Optional[Tensor] = None,
    participate: Optional[Tensor] = None,
    wire: str = "auto",
    stage_cfgs: Optional[Sequence[AggConfig]] = None,
) -> NestedResult:
    """One staged round on a client mesh — drop-in for host
    :func:`~repro_torch.agg.nested.execute_nested` (same
    :class:`~repro_torch.agg.nested.NestedResult`, bit for bit per stage).

    Every stage runs :func:`execute_sharded` on the same mesh: stage
    0 on the clients; stage s ≥ 1 on its plan padded to the mesh size, rank
    r < K_s taking sink partial r of the stage before as its gradient
    (weight 1) and row r of that stage's EF tier. The tiers are padded to
    K rows for the round and cut back after it.
    """
    if not isinstance(nested, NestedPlan):
        raise TypeError(f"expected a NestedPlan, got {type(nested)!r}")
    k, d = grads.shape
    if nested.num_clients != k:
        raise ValueError(f"nested plan has {nested.num_clients} clients, "
                         f"grads {k}")
    n_stages = nested.num_stages
    cfgs = list(stage_cfgs) if stage_cfgs is not None else [cfg] * n_stages
    if len(cfgs) != n_stages:
        raise ValueError(f"stage_cfgs has {len(cfgs)} entries for "
                         f"{n_stages} stages")
    mesh = _mesh_for(mesh, k)
    out, dt = grads.device, grads.dtype
    if stage_e is None:
        stage_e = zero_stage_ef(nested, d, out, dt)
    stage_e = tuple(stage_e)
    if len(stage_e) != n_stages - 1:
        raise ValueError(f"stage_e needs {n_stages - 1} EF tiers, got "
                         f"{len(stage_e)}")
    units = nested.stage_units
    res0 = execute_sharded(cfgs[0], nested.stages[0], grads, e, weights,
                           mesh=mesh, global_mask=global_mask,
                           participate=participate, wire=wire)
    prev = res0.aggregate
    if nested.stages[0].num_sinks == 1:
        prev = prev[None]
    stage_e_new, stage_stats = [], []
    ones = torch.ones((k,), dtype=dt, device=out)
    for s in range(1, n_stages):
        c = units[s]
        plan = _pad_plan_clients(nested.stages[s], k)
        res = execute_sharded(cfgs[s], plan, _pad_rows(prev, k),
                              _pad_rows(stage_e[s - 1], k), ones, mesh=mesh,
                              global_mask=global_mask, wire=wire)
        stage_e_new.append(res.e_new[:c])
        stage_stats.append(HopStats(*(x[:c] for x in res.stats)))
        prev = res.aggregate
        if plan.num_sinks == 1:
            prev = prev[None]
    return NestedResult(aggregate=prev[0], e_new=res0.e_new,
                        stage_e_new=tuple(stage_e_new), stats=res0.stats,
                        stage_stats=tuple(stage_stats))



# ---------------------------------------------------------------------------
# The rotated-segment lowering (the ring generalization)
# ---------------------------------------------------------------------------

def ring_chain_tree(num_ranks: int) -> AggTree:
    """The rotated ring's chain as an ``AggTree`` (reversed path tree)."""
    return AggTree(parent=tuple(range(1, num_ranks)) + (PS,))


@functools.lru_cache(maxsize=None)
def ring_chain_plan(num_ranks: int) -> AggPlan:
    """The rotated ring's chain as an :class:`AggPlan`: segment s visits
    ranks ``s, s+1, …, s+K−1`` (client 0 deepest, client K−1 next to the
    PS), so every transport offset is +1."""
    return compile_plan(ring_chain_tree(num_ranks))


def _is_static_plan(plan: AggPlan) -> bool:
    """True when the plan's leaves are host arrays — the port's plans
    always are; a plan of tensors stands for the reference's traced
    plan."""
    return not any(isinstance(a, Tensor) for a in (
        plan.node_id, plan.slot_mask, plan.parent_row, plan.alive,
        plan.q_budget))


def _host(a) -> Optional[np.ndarray]:
    if a is None:
        return None
    return np.asarray(a.cpu() if isinstance(a, Tensor) else a)


def _is_register_chain(plan: AggPlan) -> bool:
    """True for chain-structured plans: one slot per level, no padding, and
    level l's parent is level l+1's node, the last level delivering to the
    PS. Such plans (the ring chain, every permuted chain order) need no
    inbox: γ rides a single ``[seg]`` carry per rank."""
    big_l, w = plan.shape
    k = plan.num_clients
    if w != 1 or big_l != k or np.any(_host(plan.slot_mask)[:, 0] <= 0):
        return False
    ids, par = _host(plan.node_id)[:, 0], _host(plan.parent_row)[:, 0]
    return (all(par[li] == ids[li + 1] for li in range(big_l - 1))
            and par[big_l - 1] == k)


def _slot_shift(b, p, k: int):
    """Rank offset from the rank playing node b to the rank playing its
    parent p; the PS of segment s is rank s."""
    return np.where(p == k, (-b) % k, (p - b) % k)


class _Pool:
    """Host arrays gathered into one upload per device and dtype."""

    def __init__(self):
        self.parts: dict = {}
        self.size: dict = {}
        self.t: dict = {}

    def add(self, dev, a, dtype=np.int64) -> tuple:
        a = np.asarray(a, dtype).reshape(-1)
        key = (dev, np.dtype(dtype).str)
        off = self.size.get(key, 0)
        self.parts.setdefault(key, []).append(a)
        self.size[key] = off + a.size
        return key, off, a.size

    def upload(self):
        self.t = {key: torch.as_tensor(np.concatenate(p), device=key[0])
                  for key, p in self.parts.items()}

    def __getitem__(self, h) -> Tensor:
        key, off, n = h
        return self.t[key][off:off + n]


class _SegmentSchedule:
    """The index math of one rotated-segment round, made once on the host
    and uploaded in one copy per device (cached per mesh, rings, plans and
    cohort count).

    ``rings[g]`` lists the global ranks of ring g in ring order (K each);
    ``plans[g]`` is its plan, one shape for all. Rank r at ring position x
    plays plan position ``(x − s) mod K`` in segment s, so its lane of slot
    w at level l reads segment ``(x − node_id[l, w]) mod K``. A level is one
    level step per distinct device, lanes = (its ranks) × B × W, rank-major
    then cohort; a padding lane reads a zero row and writes a trash row.
    """

    def __init__(self, mesh: ClientMesh, rings: list, plans: list, b: int,
                 static: bool):
        self.mesh, self.b, self.static = mesh, b, static
        self.k = k = len(rings[0])
        self.devs = mesh.distinct()
        self.dev_idx = np.asarray([self.devs.index(d) for d in mesh.devices])
        self.ranks = {dev: np.flatnonzero(self.dev_idx == j)
                      for j, dev in enumerate(self.devs)}
        self.local = np.zeros(mesh.size, np.int64)
        for rs in self.ranks.values():
            self.local[rs] = np.arange(rs.size)
        self.mates = np.asarray(rings, np.int64)               # [G, K]
        self.ring_of = np.zeros(mesh.size, np.int64)
        self.pos = np.zeros(mesh.size, np.int64)
        for g, ring in enumerate(self.mates):
            self.ring_of[ring], self.pos[ring] = g, np.arange(k)
        self.node = np.stack([_host(p.node_id) for p in plans]).astype(
            np.int64)                                          # [G, L, W]
        self.par = np.stack([_host(p.parent_row) for p in plans]).astype(
            np.int64)
        self.real = np.stack([_host(p.slot_mask) for p in plans]) > 0
        self.levels, self.w = self.node.shape[1:]
        self.register = static and all(map(_is_register_chain, plans))
        self.pool = pool = _Pool()
        alive = np.stack([_host(p.alive) for p in plans])      # [G, K]
        budgets = (None if plans[0].q_budget is None
                   else np.stack([_host(p.q_budget) for p in plans]))
        self.alive, self.qb, self.lanes = {}, {}, []
        for dev, rs in self.ranks.items():
            g, x = self.ring_of[rs], self.pos[rs]
            self.alive[dev] = pool.add(dev, alive[g, x], np.float32)
            self.qb[dev] = (None if budgets is None
                            else pool.add(dev, budgets[g, x]))
        for li in range(self.levels):
            lvl = {}
            for dev, rs in self.ranks.items():
                g = self.ring_of[rs]
                ids, valid = self.node[g, li], self.real[g, li]    # [nr, W]
                s_w = (self.pos[rs][:, None] - ids) % k
                s_read = np.where(valid, s_w, k)
                lvl[dev] = dict(
                    x=pool.add(dev, self._rows(rs.size, s_read, k + 1)),
                    e_read=pool.add(dev, self._rows(rs.size, s_read, k + 2)),
                    e_write=pool.add(dev, self._rows(
                        rs.size, np.where(valid, s_w, k + 1), k + 2)),
                    inbox=pool.add(dev, self._rows(
                        rs.size, np.where(valid, s_w, k + 2), k + 3)),
                    valid=pool.add(dev, np.broadcast_to(
                        valid[:, None, :], (rs.size, b, self.w)), np.float32))
            self.lanes.append(lvl)
        if self.register:
            g = self.ring_of
            self.chain_routes = [self._route(_slot_shift(
                self.node[g, li, 0], self.par[g, li, 0], k))
                for li in range(self.levels)]
        elif static:
            self.sends = [self._static_sends(li)
                          for li in range(self.levels)]
        else:
            self.rounds = max(1, math.ceil(math.log2(k))) if k > 1 else 0
            self.shift_routes = [self._route(np.full(mesh.size, 2 ** j))
                                 for j in range(self.rounds)]
            self.bfly = [self._butterfly_level(li)
                         for li in range(self.levels)]
        pool.upload()

    def _rows(self, nr: int, per_rank: np.ndarray, stride: int) -> np.ndarray:
        """Flat row indices ``(i·B + b)·stride + per_rank[i, w]`` of the
        lanes (i, b, w) of a device's block."""
        base = (np.arange(nr)[:, None] * self.b
                + np.arange(self.b)[None, :]) * stride          # [nr, B]
        return base[:, :, None] + per_rank[:, None, :]

    def _route(self, shift: np.ndarray) -> dict:
        """Receiver device → [(sender device, sender locals, receiver
        locals, count)]: receiver r takes the row of its ring-mate at ring
        position ``pos(r) − shift[r]``."""
        out = {}
        for dev, rs in self.ranks.items():
            src = self.mates[self.ring_of[rs],
                             (self.pos[rs] - shift[rs]) % self.k]
            parts = []
            for j, sdev in enumerate(self.devs):
                on = np.flatnonzero(self.dev_idx[src] == j)
                if on.size:
                    parts.append((sdev, self.pool.add(sdev,
                                                      self.local[src[on]]),
                                  self.pool.add(dev, on), on.size))
            out[dev] = parts
        return out

    def _static_sends(self, li: int) -> list:
        """Per real slot of the (shared) plan, per (sender device, receiver
        device): the senders (None: all, in order) and their receivers'
        inbox rows, in sender order."""
        k, b = self.k, self.b
        out = []
        for wi in np.flatnonzero(self.real[0, li]):
            node, par = int(self.node[0, li, wi]), int(self.par[0, li, wi])
            shift = int(_slot_shift(node, par, k))
            recv = self.mates[self.ring_of, (self.pos + shift) % k]
            row = (np.full(self.mesh.size, k) if par == k
                   else (self.pos - par) % k)
            pairs = []
            for sdev, srs in self.ranks.items():
                for j, ddev in enumerate(self.devs):
                    on = np.flatnonzero(self.dev_idx[recv[srs]] == j)
                    if not on.size:
                        continue
                    to = recv[srs[on]]
                    rows = ((self.local[to][:, None] * b
                             + np.arange(b)[None, :]) * (k + 3)
                            + row[to][:, None])
                    pairs.append((sdev, ddev,
                                  None if on.size == srs.size
                                  else self.pool.add(sdev, on),
                                  self.pool.add(ddev, rows)))
            out.append((int(wi), pairs))
        return out

    def _butterfly_level(self, li: int) -> dict:
        """Per device: the bit j of every lane's offset for each round, and
        per slot the receivers' inbox rows (padding → trash)."""
        k, b = self.k, self.b
        out = {}
        for dev, rs in self.ranks.items():
            g = self.ring_of[rs]
            ids, par, valid = (self.node[g, li], self.par[g, li],
                               self.real[g, li])
            off = _slot_shift(ids, par, k)
            takes = [self.pool.add(dev, (off >> j) & 1)
                     for j in range(self.rounds)]
            row = np.where(valid, np.where(par == k, k,
                                           (self.pos[rs][:, None] - par) % k),
                           k + 1)                               # [nr, W]
            base = (np.arange(rs.size)[:, None] * b
                    + np.arange(b)[None, :]) * (k + 3)          # [nr, B]
            out[dev] = (takes, [self.pool.add(dev, base + row[:, wi][:, None])
                                for wi in range(self.w)])
        return out


_SCHEDULES: dict = {}       # the counterpart of the reference's jit cache


def _schedule(mesh: ClientMesh, rings: list, plans: list, b: int,
              static: bool) -> _SegmentSchedule:
    """The cached schedule of (mesh, rings, plans' arrays, B, transport);
    at most 64 are kept."""
    def leaves(p):
        return tuple(None if a is None else (_host(a).shape,
                                             _host(a).tobytes())
                     for a in (p.node_id, p.slot_mask, p.parent_row, p.alive,
                               p.q_budget))

    key = (mesh.devices, tuple(map(tuple, rings)), b, static,
           tuple(leaves(p) for p in plans))
    if key not in _SCHEDULES:
        if len(_SCHEDULES) >= 64:
            _SCHEDULES.pop(next(iter(_SCHEDULES)))
        _SCHEDULES[key] = _SegmentSchedule(mesh, rings, plans, b, static)
    return _SCHEDULES[key]


def _deliver(sched: _SegmentSchedule, blocks: dict, route: dict,
             send) -> dict:
    """Per-device ``[nr, ...]`` blocks moved along a route: receiver r gets
    its sender's row; ``send(rows, device)`` carries them (see
    :func:`to_device`: a copy only between devices)."""
    pool, out = sched.pool, {}
    for dev, parts in route.items():
        nr = sched.ranks[dev].size
        if len(parts) == 1 and parts[0][3] == nr:     # receivers in order
            sdev, snd = parts[0][:2]
            out[dev] = send(blocks[sdev].index_select(0, pool[snd]), dev)
            continue
        moved = None
        for sdev, snd, rcv, _ in parts:
            rows = send(blocks[sdev].index_select(0, pool[snd]), dev)
            if moved is None:
                moved = rows.new_empty((nr,) + tuple(rows.shape[1:]))
            moved.index_copy_(0, pool[rcv], rows)
        out[dev] = moved
    return out


def _slot_sum(x: Tensor) -> Tensor:
    """Σ over the last axis in a fixed pairwise order: elementwise adds
    only, so the sum is the same on every device and for any number of
    rows (the order of a torch reduction depends on both)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        head = x[..., :h] + x[..., h:2 * h]
        x = head if x.shape[-1] % 2 == 0 else torch.cat(
            [head, x[..., 2 * h:]], -1)
    return x[..., 0]


def _inbox_add(inbox: Tensor, rows: Tensor, vals: Tensor):
    """Add ``vals`` into distinct inbox rows: one add per row, so the sum
    does not depend on an order of adds."""
    seg = inbox.shape[-1]
    flat = inbox.view(-1, seg)
    flat.index_copy_(0, rows, flat.index_select(0, rows)
                     + vals.reshape(-1, seg))


def _segment_round(cfg: AggConfig, sched: _SegmentSchedule, compact: bool,
                   flat: list, ef: list, weight: list, gm: list,
                   part: list) -> tuple:
    """Run one round of a schedule. Per rank: ``flat``, ``ef`` and ``gm``
    (or Nones) ``[B, n]``, ``weight`` and ``part`` (or Nones) ``[B]`` float32,
    on ``mesh.devices[r]``. Returns per-rank lists: final segment ``[B,
    seg]``, EF ``[B, n]`` (storage dtype) and :class:`RingStats` with
    ``[B]`` leaves."""
    k, nb, w, pool = sched.k, sched.b, sched.w, sched.pool
    n = flat[0].shape[-1]
    seg = n // k
    lvl_fn = level_step(cfg)

    def send_gamma(x, dev):
        return _send(cfg, x, dev, compact)

    st = {}
    for dev, rs in sched.ranks.items():
        nr = rs.size

        def ext(xs, extra):
            body = torch.stack([to_device(xs[r], dev) for r in rs])
            return torch.cat([body.reshape(nr, nb, k, seg),
                              body.new_zeros((nr, nb, extra, seg))], 2)

        lanes = nr * nb * w
        p_eff = pool[sched.alive[dev]][:, None]
        if part[rs[0]] is not None:
            p_eff = torch.stack([part[r] for r in rs]) * p_eff
        qb = (None if sched.qb[dev] is None
              else pool[sched.qb[dev]].to(torch.int32)[:, None].expand(nr, nb))

        def per_lane(v):
            return None if v is None else v.reshape(nr * nb, 1).expand(
                nr * nb, w).reshape(lanes)

        ef_ext = ext(ef, 2)
        st[dev] = dict(
            x=ext(flat, 1).view(-1, seg), ef=ef_ext,
            ef_flat=ef_ext.view(-1, seg),
            gm=None if gm[rs[0]] is None else ext(gm, 1).view(-1, seg),
            w=per_lane(torch.stack([weight[r] for r in rs])),
            p=per_lane(p_eff.expand(nr, nb)), qb=per_lane(qb),
            gm0=torch.zeros((seg,), dtype=torch.float32, device=dev),
            acc=torch.zeros((3, nr * nb), dtype=torch.float32, device=dev))
        if sched.register:
            st[dev]["gamma"] = torch.zeros((nr, nb, seg),
                                           dtype=torch.float32, device=dev)
        else:
            st[dev]["inbox"] = torch.zeros((nr, nb, k + 3, seg),
                                           dtype=torch.float32, device=dev)

    for li in range(sched.levels):
        gout = {}
        for dev, rs in sched.ranks.items():
            s, ix = st[dev], sched.lanes[li][dev]
            x_rows = pool[ix["x"]]
            g_l = s["x"].index_select(0, x_rows).to(torch.float32)
            e_l = s["ef_flat"].index_select(0, pool[ix["e_read"]]).to(
                torch.float32)
            m_l = (s["gm0"] if s["gm"] is None
                   else s["gm"].index_select(0, x_rows).to(torch.float32))
            if sched.register:
                gam, valid = s["gamma"].view(-1, seg), None
            else:
                gam = s["inbox"].view(-1, seg).index_select(
                    0, pool[ix["inbox"]])
                valid = pool[ix["valid"]]
            out, e_new, hs = lvl_fn(g_l, gam, e_l, s["w"], s["p"], m_l,
                                    s["qb"], valid)
            s["ef_flat"].index_copy_(0, pool[ix["e_write"]],
                                     e_new.to(s["ef_flat"].dtype))
            # (bits, nnz, err_sq) per lane; a rank's real slots summed
            lvl = torch.stack([hs.bits, hs.nnz_out.to(torch.float32),
                               hs.err_sq])
            if not sched.register:
                lvl = _slot_sum(lvl.view(3, -1, w) * valid.view(-1, w))
            s["acc"] = s["acc"] + lvl
            gout[dev] = out.view(rs.size, nb, w, seg)
            # free this level's lanes before the next level makes its own
            del g_l, e_l, m_l, gam, out, e_new, hs, lvl
        if sched.register:
            moved = _deliver(sched, {d: v[:, :, 0] for d, v in gout.items()},
                             sched.chain_routes[li], send_gamma)
            for dev, v in moved.items():
                st[dev]["gamma"] = v
        elif sched.static:
            # a receiver on the sender's device takes the level's γ after
            # the wire, made once for all slots; another device is sent
            # its rows over the wire
            local = {}
            for wi, pairs in sched.sends[li]:
                for sdev, ddev, snd, rows in pairs:
                    if sdev == ddev:
                        if sdev not in local:
                            local[sdev] = send_gamma(gout[sdev], sdev)
                        vals = local[sdev][:, :, wi]
                    else:
                        vals = gout[sdev][:, :, wi]
                    if snd is not None:
                        vals = vals.index_select(0, pool[snd])
                    if sdev != ddev:
                        vals = send_gamma(vals, ddev)
                    _inbox_add(st[ddev]["inbox"], pool[rows], vals)
        else:
            _butterfly(cfg, sched, li, gout, st, compact)

    res_seg, res_ef, res_st = ([None] * sched.mesh.size for _ in range(3))
    for dev, rs in sched.ranks.items():
        s = st[dev]
        fin = s["gamma"] if sched.register else s["inbox"][:, :, k]
        for i, r in enumerate(rs):
            res_seg[r] = fin[i]
            res_ef[r] = s["ef"][i, :, :k].reshape(nb, n)
            res_st[r] = RingStats(*s["acc"].view(3, rs.size, nb)[:, i])
    return res_seg, res_ef, res_st


def _butterfly(cfg: AggConfig, sched: _SegmentSchedule, li: int, gout: dict,
               st: dict, compact: bool):
    """A level's γ through ⌈log₂K⌉ whole-bundle shifts by 2^j, each slot
    keeping the shifted copy where bit j of its offset is set; then the
    inbox adds, slot by slot in slot order (padding slots add zeros into
    the trash row)."""
    w, pool = sched.w, sched.pool
    bundle = {}
    for dev, out in gout.items():
        valid = pool[sched.lanes[li][dev]["valid"]]
        payload = out * valid.view(out.shape[:3])[..., None]
        if compact:
            vals, idx, _ = sp.compact(payload, _wire_budget(cfg))
            bundle[dev] = (vals.to(_WIRE_DTYPES[cfg.wire_dtype]), idx)
        else:
            bundle[dev] = (payload,)
    parts = len(next(iter(bundle.values())))
    for j in range(sched.rounds):
        moved = [_deliver(sched, {d: v[t] for d, v in bundle.items()},
                          sched.shift_routes[j], to_device)
                 for t in range(parts)]
        for dev in bundle:
            take = (pool[sched.bfly[li][dev][0][j]] > 0).view(
                sched.ranks[dev].size, 1, w, 1)
            bundle[dev] = tuple(torch.where(take, m[dev], v)
                                for m, v in zip(moved, bundle[dev]))
    for dev, v in bundle.items():
        arrived = (sp.scatter(v[0].to(torch.float32), v[1],
                              gout[dev].shape[-1]) if compact else v[0])
        for wi in range(w):
            _inbox_add(st[dev]["inbox"], pool[sched.bfly[li][dev][1][wi]],
                       arrived[:, :, wi])


def _transport_static(plan: AggPlan, transport: str) -> bool:
    if transport not in ("auto", "static", "butterfly"):
        raise ValueError(f"unknown transport {transport!r}")
    static = (_is_static_plan(plan) if transport == "auto"
              else transport == "static")
    if static and not _is_static_plan(plan):
        raise ValueError("transport='static' needs a host plan (numpy "
                         "arrays, not tensors)")
    return static


def _segments_compact(cfg: AggConfig, seg: int, plan: AggPlan,
                      participate_present: bool, wire: str,
                      host_plan: bool) -> bool:
    """The wire rule evaluated on the segment width. Unlike the
    client-per-rank path, a bf16 ``wire_dtype`` travels under
    ``wire="auto"`` too, as in the reference; where the reference's plan
    is traced (the per-cluster trees of a nested stage) ``"auto"`` sends
    dense."""
    if wire == "auto" and not host_plan:
        return False
    return _use_compact(cfg, seg, plan, participate_present, wire)


def _rank_rows(xs, b: int, mesh: ClientMesh, name: str) -> list:
    """Per-rank ``[B]`` float32 tensors on ``mesh.devices[r]`` from K values
    or one value for every rank (numbers, 0-d or ``[B]`` tensors); numbers
    go up in one copy per device."""
    k = mesh.size
    xs = (_rank_list(xs, k, name) if isinstance(xs, (list, tuple))
          else [xs] * k)
    if not any(isinstance(x, Tensor) for x in xs):
        arr = np.broadcast_to(np.asarray(xs, np.float32).reshape(k, -1),
                              (k, b))
        return _Ranks(mesh).rows(torch.from_numpy(np.array(arr)))
    return [to_device(torch.as_tensor(x).to(torch.float32).reshape(-1), dev)
            .expand(b) for x, dev in zip(xs, mesh.devices)]


def _rank_list(xs, k: int, name: str) -> list:
    xs = list(xs)
    if len(xs) != k:
        raise ValueError(f"{name} has {len(xs)} entries for {k} ranks")
    return xs


def run_plan_segments_batched(
    cfg: AggConfig,
    plan: AggPlan,
    mesh: ClientMesh,
    flat: Sequence[Tensor],           # per rank: [B, n] on devices[r]
    ef: Sequence[Tensor],             # per rank: [B, n] EF rows
    weight,                           # per rank: [B] D_k (or one value)
    *,
    global_mask: Optional[Sequence[Tensor]] = None,   # per rank [B, n]
    participate=None,                 # per rank: [B] 0/1 (or one value)
    transport: str = "auto",          # "auto" | "static" | "butterfly"
    wire: str = "auto",               # "auto" | "compact" | "dense"
) -> tuple:
    """Cohort-batched :func:`run_plan_segments_local`: one shared plan, B
    tenants per rank, each level one level step per device for all
    cohorts and one transport per hop.

    Per cohort, bit for bit what the sequential lowering returns. Returns
    per-rank lists ``(final segment [B, seg], EF [B, n], RingStats with
    [B] leaves)``.
    """
    if np.ndim(_host(plan.node_id)) == 3:
        raise ValueError("the batched segments kernel runs one shared "
                         "plan; stacked per-cohort plans are a host "
                         "(execute_batched) feature")
    k = mesh.size
    if plan.num_clients != k:
        raise ValueError(f"plan has {plan.num_clients} clients but the mesh "
                         f"has {k} ranks")
    if plan.num_sinks != 1:
        raise ValueError("the batched segments kernel runs single-sink "
                         "plans")
    flat = _rank_list(flat, k, "flat")
    ef = _rank_list(ef, k, "ef")
    b, n = flat[0].shape
    if n % k:
        raise ValueError(f"the flat length {n} is not a multiple of the "
                         f"{k} ranks")
    static = _transport_static(plan, transport)
    compact = _segments_compact(cfg, n // k, plan, participate is not None,
                                wire, _is_static_plan(plan))
    gm = ([None] * k if global_mask is None
          else _rank_list(global_mask, k, "global_mask"))
    part = ([None] * k if participate is None
            else _rank_rows(participate, b, mesh, "participate"))
    sched = _schedule(mesh, [list(range(k))], [plan], b, static)
    return _segment_round(cfg, sched, compact, flat, ef,
                          _rank_rows(weight, b, mesh, "weight"), gm, part)


def run_plan_segments_local(
    cfg: AggConfig,
    plan: AggPlan,
    mesh: ClientMesh,
    flat: Sequence[Tensor],           # per rank: [n] gradient slice
    ef: Sequence[Tensor],             # per rank: [n] EF memory
    weight,                           # per rank: scalar D_k (or one value)
    *,
    global_mask: Optional[Sequence[Tensor]] = None,   # per rank [n]
    participate=None,                 # per rank: scalar 0/1 (or one value)
    transport: str = "auto",          # "auto" | "static" | "butterfly"
    wire: str = "auto",               # "auto" | "compact" | "dense"
) -> tuple:
    """Execute an AggPlan over the K-rank ring, one rotated copy per
    segment (``n % K == 0``).

    Segment s runs the plan with tree positions relabelled by ``+s (mod
    K)`` and its parameter server at rank s, so after the round rank r
    holds the fully-aggregated segment r (the ring's ownership layout).
    Per segment the value path is bit for bit host
    :func:`~repro_torch.agg.plan.execute` on that segment under the
    relabelling; on :func:`ring_chain_plan` this is the rotated ring.
    Returns per-rank lists ``(final segment [n // K], new EF [n],
    RingStats of 0-d leaves)``; the caller sums the stats.

    Chain-structured plans take the register path: γ is one ``[seg]``
    carry per rank, each level one level step of the device's ranks (no
    inbox). Other plans keep an f32 inbox of ``K + 3`` rows per rank (K
    segments, the PS accumulator, a trash row and a zero dummy); each level
    is one level step of (ranks × W) lanes per device, and each real slot
    delivers by one rank-uniform shift, added into the receivers' rows in
    slot order. ``transport="butterfly"`` routes a level through ⌈log₂K⌉
    whole-bundle shifts instead, as the reference does for traced plans;
    the port's plans are host arrays, so ``"auto"`` is ``"static"``. The
    compact ``(values, indices)`` wire carries values in
    ``cfg.wire_dtype``.

    ``participate``, ``plan.alive`` and ``plan.q_budget`` are
    physical-rank properties: rank r straggles, is stranded or owns a
    narrow uplink in every segment, whatever position it plays.
    """
    if plan.num_sinks != 1:
        raise ValueError(
            "the segments kernel runs single-sink plans; lower a "
            "NestedPlan through run_nested_segments_local")
    k = mesh.size
    fin, e_new, stats = run_plan_segments_batched(
        cfg, plan, mesh, [x[None] for x in _rank_list(flat, k, "flat")],
        [x[None] for x in _rank_list(ef, k, "ef")], weight,
        global_mask=(None if global_mask is None else
                     [m[None] for m in _rank_list(global_mask, k,
                                                  "global_mask")]),
        participate=participate, transport=transport, wire=wire)
    return ([x[0] for x in fin], [x[0] for x in e_new],
            [RingStats(*(f[0] for f in st)) for st in stats])


def run_nested_segments_local(
    cfg: AggConfig,
    nested: NestedPlan,
    mesh: ClientMesh,
    flat: Sequence[Tensor],           # per rank: [n] gradient slice
    ef: Sequence[Tensor],             # per rank: [n] client-tier EF
    stage_ef: Sequence,               # per stage ≥ 1: per-rank EF slices,
                                      # stage s [n // prod(K_0..K_{s-1})]
    weight,                           # per rank: scalar D_k (stage 0)
    *,
    sizes: Sequence[int],             # one axis size per stage, stage 0
                                      # first: (K_data, K_pod)
    global_mask: Optional[Sequence[Tensor]] = None,   # per rank [n]
    participate=None,                 # per rank: scalar 0/1 (stage 0)
    transport: str = "auto",          # "auto" | "static" | "butterfly"
    wire: str = "auto",
    stage_cfgs: Optional[Sequence[AggConfig]] = None,
) -> tuple:
    """Execute a :class:`~repro_torch.agg.nested.NestedPlan` over a
    multi-axis mesh: stage s runs the rotated-segment lowering over axis s.

    The mesh has ``prod(sizes)`` ranks; rank k has axis coordinates
    ``(r_0, r_1, …)`` with ``k = … + r_1·K_0 + r_0`` (later axes major,
    the reference's (pod, data) order). Stage s runs one ring per rank
    group that shares every coordinate but ``r_s``, all rings of the stage
    in the same level steps. Stage 0 runs each cluster's intra tree (cluster
    c = the group with later coordinates c, so the plan must be
    mesh-aligned); stage s ≥ 1 folds the previous stage's owned segment
    with weight 1 and that stage's EF tier. Identical clusters take the
    shared subplan with the requested transport (the chain×chain plan is
    the two-stage rotated ring); per-cluster trees run each group's own
    subplan through the butterfly, as the reference does. The TCS mask of
    stage s is the rank's slice of the previous stage's segment.

    Returns per-rank lists ``(final segment [n // prod(sizes)], client EF
    [n], tuple of per-stage EF tiers, tuple of per-stage RingStats)``.
    """
    if not isinstance(nested, NestedPlan):
        raise TypeError(f"expected a NestedPlan, got {type(nested)!r}")
    n_stages = nested.num_stages
    sizes = tuple(int(s) for s in sizes)
    if len(sizes) != n_stages:
        raise ValueError(f"nested plan has {n_stages} stages but "
                         f"{len(sizes)} axis sizes were given")
    cfgs = list(stage_cfgs) if stage_cfgs is not None else [cfg] * n_stages
    if len(cfgs) != n_stages:
        raise ValueError(f"stage_cfgs has {len(cfgs)} entries for "
                         f"{n_stages} stages")
    stage_ef = tuple(stage_ef)
    if len(stage_ef) != n_stages - 1:
        raise ValueError(f"need {n_stages - 1} stage-EF slices, got "
                         f"{len(stage_ef)}")
    total = int(np.prod(sizes))
    if nested.num_clients != total:
        raise ValueError(f"nested plan has {nested.num_clients} clients but "
                         f"the axes {sizes!r} provide {total} ranks")
    if mesh.size != total:
        raise ValueError(f"the axes {sizes!r} provide {total} ranks but the "
                         f"mesh has {mesh.size}")
    if transport not in ("auto", "static", "butterfly"):
        raise ValueError(f"unknown transport {transport!r}")

    ranks = np.arange(total)
    cur = [x[None] for x in _rank_list(flat, total, "flat")]
    cur_mask = (None if global_mask is None else
                [m[None] for m in _rank_list(global_mask, total,
                                             "global_mask")])
    ef_new, stage_ef_new, stage_stats = None, [], []
    inner = 1                                   # prod(K_0 .. K_{s-1})
    for s in range(n_stages):
        k_s = sizes[s]
        outer = inner * k_s
        rings = [[hi * outer + x * inner + lo for x in range(k_s)]
                 for hi in range(total // outer) for lo in range(inner)]
        host_plan = True
        if s == n_stages - 1:
            plans = [nested.stages[s]] * len(rings)
            static = _transport_static(plans[0], transport)
        else:
            clustered = nested.clustered[s]
            if clustered.num_units != k_s:
                raise ValueError(
                    f"stage {s} clusters have {clustered.num_units} members "
                    f"but axis {s} has {k_s} ranks")
            if not clustered.mesh_aligned():
                raise ValueError(
                    f"stage {s} clusters are not mesh-aligned (cluster c "
                    f"must be clients c·{k_s}..c·{k_s}+{k_s - 1}); "
                    f"re-cluster or run on host")
            if transport != "butterfly" and clustered.uniform():
                plans = [clustered.subplan(0)] * len(rings)
                static = _transport_static(plans[0], transport)
            else:
                if transport == "static":
                    raise ValueError(
                        "transport='static' needs identical trace-time-"
                        "constant cluster plans; per-cluster trees route "
                        "through the butterfly")
                # cluster of a ring = its later coordinates (ring[0] // outer)
                plans = [clustered.subplan(ring[0] // outer)
                         for ring in rings]
                static, host_plan = False, False
        n = cur[0].shape[-1]
        if n % k_s:
            raise ValueError(f"stage {s}: the segment length {n} is not a "
                             f"multiple of the {k_s} ranks of its axis")
        first = s == 0
        compact = _segments_compact(cfgs[s], n // k_s, plans[0],
                                    first and participate is not None, wire,
                                    host_plan)
        ef_s = ef if first else stage_ef[s - 1]
        sched = _schedule(mesh, rings, plans, 1, static)
        seg_out, ef_out, st = _segment_round(
            cfgs[s], sched, compact, cur,
            [x[None] for x in _rank_list(ef_s, total, "ef")],
            _rank_rows(weight if first else 1.0, 1, mesh, "weight"),
            [None] * total if cur_mask is None else cur_mask,
            ([None] * total if not first or participate is None
             else _rank_rows(participate, 1, mesh, "participate")))
        ef_out = [x[0] for x in ef_out]
        if first:
            ef_new = ef_out
        else:
            stage_ef_new.append(ef_out)
        stage_stats.append([RingStats(*(f[0] for f in x)) for x in st])
        if s < n_stages - 1 and cur_mask is not None:
            seg = seg_out[0].shape[-1]
            r_s = (ranks // inner) % k_s
            cur_mask = [m[:, r_s[r] * seg:(r_s[r] + 1) * seg]
                        for r, m in enumerate(cur_mask)]
        cur = seg_out
        inner = outer
    return ([x[0] for x in cur], ef_new, tuple(stage_ef_new),
            tuple(stage_stats))
