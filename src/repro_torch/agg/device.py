"""Device-plan execution, client per rank (port of the client-per-rank half
of :mod:`repro.agg.device`).

Any :class:`~repro_torch.agg.plan.AggPlan` — chain, permuted order, routed
tree, one step of a :class:`~repro_torch.agg.schedule.TopologySchedule`, a
stage of a :class:`~repro_torch.agg.nested.NestedPlan` — runs over a
:class:`ClientMesh`: rank r is client r, and its gradient, error-feedback
row, inbox and node-step outputs stay on ``mesh.devices[r]``. One round is
level-synchronous and bit-exact to the host executors
(:func:`~repro_torch.agg.plan.execute`, ``execute_batched``,
:func:`~repro_torch.agg.nested.execute_nested`): the same aggregate, EF
rows and per-client §V :class:`~repro_torch.core.algorithms.HopStats`.
This is the backend behind ``Simulator(backend="device")``.

The reference lowers the plan into one SPMD ``shard_map`` body over a mesh
of ``jax.devices()`` (faked on the CPU with
``--xla_force_host_platform_device_count``). The port has one controller
that holds the plan's numpy arrays, so its body is a loop over the ranks:

* only the ranks that hold a real slot of a level step at that level, one
  W = 1 fused level step each (lanes = B in the cohort form) — the
  reference runs the node step on every rank at every level and keeps the
  active results with a select;
* each slot's γ goes point to point, ``tensor.to(mesh.devices[parent])``
  — a peer copy between cards (asynchronous), a synchronous copy between
  a card and the CPU, nothing where both ranks share a device — and is
  added into the parent's inbox, one add per real slot in slot order
  (never ``index_add_``, whose CUDA order is not fixed). A γ bound for a
  sink goes to the one copy of the sink rows on the caller's device. The
  reference all-gathers every payload and scatter-adds;
* the compact ``(values[q], indices[q])`` wire of the CL algorithms is
  taken where :func:`_use_compact` allows it, as in the reference. The
  port's plans are always host arrays (the reference's ``_is_static_plan``
  is always true), so ``wire="auto"`` may pick the compact wire where the
  reference's jitted simulator, with a traced plan, sends dense; both give
  the same values.

A mesh may name one device several times (``client_mesh(28,
devices=["cuda:0"] * 28)`` on one card, ``["cpu"] * 8`` in the tests) —
the counterpart of the reference's fake host devices. The rotated-segment
lowering (``run_plan_segments_local``, the ring) is not here yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.agg.nested import NestedPlan, NestedResult, zero_stage_ef
from repro_torch.agg.plan import AggPlan, RoundResult
from repro_torch.core import sparsify as sp
from repro_torch.core.algorithms import (AggConfig, AggKind, HopStats,
                                         level_step_batched)
from repro_torch.device import resolve_device

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


def _to(x: Tensor, dst: torch.device) -> Tensor:
    """``x`` on ``dst``. Asynchronous only between two cards: a copy from a
    card to the CPU returns before it lands (pinned staging), and the CPU
    code reads the result at once."""
    return x.to(dst, non_blocking=x.device.type == "cuda"
                and dst.type == "cuda")


def _send(cfg: AggConfig, payload: Tensor, dst: torch.device,
          compact: bool) -> Tensor:
    """One hop: ``payload`` (``[d]`` or ``[B, d]``) delivered on ``dst``.

    Dense: the tensor itself, copied to ``dst`` (no copy on its own
    device). Compact: the sender keeps ``(values[q], indices[q])`` per row
    (values in ``cfg.wire_dtype``), those travel, and the receiver
    scatters them back into zeros of the payload's dtype.
    """
    if not compact:
        return _to(payload, dst)
    d = payload.shape[-1]
    vals, idx, _ = sp.compact(payload, _wire_budget(cfg))
    vals = _to(vals.to(_WIRE_DTYPES[cfg.wire_dtype]), dst)
    return sp.scatter(vals.to(payload.dtype), _to(idx, dst), d)


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
        return {dev: _to(x, dev) for dev in self.mesh.distinct()}

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
    return torch.stack([_to(r, out_device).to(dtype) for r in rows],
                       dim=dim)


def _gather_stats(stats: list, out_device, dim: int = 0) -> HopStats:
    return HopStats(*(torch.cat([_to(s[f], out_device) for s in stats],
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
