"""Multi-hop FL simulator — the paper's §VI experiment (port of
:mod:`repro.fed.simulator`, host backend with flat plans).

K clients train a d = 7850 logistic-regression model on synthetic MNIST.
Per round:

  1. every client takes one SGD step on its local minibatch → effective
     gradient g_k = −lr·∇_k;
  2. the round's aggregation topology — the chain, a permuted chain via
     ``order_fn``, a routed constellation tree (``tree_topology``, re-routed
     around the dead relays of a ``failure_schedule``), a
     ``topology_schedule``, or any compiled
     :class:`~repro_torch.agg.AggPlan` — aggregates {D_k·g_k} with the
     configured Algorithm 1–5 (error feedback persists across rounds);
  3. the PS applies w ← w + γ_1 / D.

Rounds run on ``cuda`` unless the simulator is built with another
``device``; with no card and no ``device="cpu"`` construction raises.
Minibatch draws come from a CPU ``torch.Generator`` seeded by
:meth:`Simulator.run`, or are passed in by the caller
(:meth:`Simulator.round_fn`'s ``batch_idx``), so a test can replay
another implementation's draws.

:meth:`Simulator.run_batched` trains B independent cohorts (one seed
each) over the same constellation: each round takes every cohort's
gradients as its own round would, then aggregates all B cohorts with one
level step per level (:func:`repro_torch.agg.plan.execute_batched`).
Cohort i of a batched run is ``run(seed=seeds[i])`` bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.agg.plan import (AggPlan, Topology, compile_plan, execute,
                                  execute_batched)
from repro_torch.agg.schedule import TopologySchedule
from repro_torch.configs.paper_mnist import PaperConfig
from repro_torch.core import tcs as tcs_mod
from repro_torch.core.algorithms import AggConfig, AggKind
from repro_torch.data.federated import FederatedData, client_minibatch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fed.topology import FailureSchedule, TreeTopology
from repro_torch.topo.routing import NestedTopology
# re-exported: this module held them before repro_torch.runtime.fault
from repro_torch.runtime.fault import (banked_mass,  # noqa: F401
                                       dead_banked_mass)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Logistic-regression model (w: [784, 10], b: [10] — d = 7850)
# ---------------------------------------------------------------------------

class LogisticRegression(nn.Module):
    """``logits = x @ w + b`` with the reference's parameter layout."""

    def __init__(self, pc: PaperConfig):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(pc.input_dim, pc.num_classes))
        self.b = nn.Parameter(torch.zeros(pc.num_classes))

    def forward(self, x: Tensor) -> Tensor:
        return x @ self.w + self.b


def lr_init(pc: PaperConfig, device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    return {"w": torch.zeros((pc.input_dim, pc.num_classes), device=dev),
            "b": torch.zeros((pc.num_classes,), device=dev)}


def _logits(params: dict, x: Tensor) -> Tensor:
    return x @ params["w"] + params["b"]


def lr_loss(params: dict, x: Tensor, y: Tensor) -> Tensor:
    logp = torch.log_softmax(_logits(params, x), dim=-1)
    return -torch.take_along_dim(logp, y[:, None], dim=1).mean()


def lr_accuracy(params: dict, x: Tensor, y: Tensor) -> Tensor:
    return (_logits(params, x).argmax(-1) == y).to(torch.float32).mean()


def flatten_lr(params: dict) -> Tensor:
    return torch.cat([params["w"].reshape(-1), params["b"]])


def unflatten_lr(flat: Tensor, pc: PaperConfig) -> dict:
    wd = pc.input_dim * pc.num_classes
    return {"w": flat[:wd].reshape(pc.input_dim, pc.num_classes),
            "b": flat[wd:wd + pc.num_classes]}


# ---------------------------------------------------------------------------
# Simulator
# ---------------------------------------------------------------------------

class SimState(NamedTuple):
    round: int              # rounds completed
    flat_w: Tensor          # [d] global model
    ef: Tensor              # [K, d] error feedback
    tcs_prev: Tensor        # [d] w^{t-1} (used by TC algorithms)


class RoundLog(NamedTuple):
    """Per-round telemetry, with the reference's fields in its order.

    Leaves stay on the device until :meth:`run` reads them after the last
    round. ``stats`` holds the per-stage
    :class:`~repro_torch.core.algorithms.HopStats` (stage 0 = the client
    forest, leaves [K] in client index order; flat plans have that one
    stage), and ``stage_ef_mass`` the banked mass of each upper EF tier of a
    nested plan (none for flat plans).
    """

    loss: Tensor            # full-train-set loss after the update
    stats: tuple            # per-stage HopStats (§V exact per-hop bits)
    participation: Tensor   # [K] effective mask (participate ∧ alive)
    ef_mass: Tensor         # [K] ‖e_k‖₁ banked after this round
    stage_ef_mass: tuple    # banked mass per upper EF tier ([K_s] each)
    ef_dead_mass: Tensor    # Σ over non-participants of ‖e_k‖₁


@dataclasses.dataclass
class Simulator:
    """Multi-hop FL simulator over flat aggregation plans.

    The default topology is the paper's identity chain. ``tree_topology``
    routes a constellation graph instead; relay deaths from a
    ``failure_schedule`` passed to :meth:`run` re-route the tree (re-rooting
    the severed subtree through surviving ISLs).
    """

    pc: PaperConfig
    agg: AggConfig
    fed: FederatedData
    local_lr: float = 0.1
    tree_topology: Optional[TreeTopology] = None
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if (self.tree_topology is not None
                and self.tree_topology.num_clients != self.fed.num_clients):
            raise ValueError(
                f"tree topology has {self.tree_topology.num_clients} "
                f"clients, data has {self.fed.num_clients}")
        self.fed = FederatedData(x=self.fed.x.to(self.device),
                                 y=self.fed.y.to(self.device))
        self.k = self.fed.num_clients
        self.d = self.pc.d
        # D_k: uniform per-round contribution weights, normalized at the PS
        self.weights = torch.ones((self.k,), device=self.device)
        self.model = LogisticRegression(self.pc).to(self.device)

    def init(self) -> SimState:
        flat = flatten_lr(lr_init(self.pc, self.device))
        return SimState(round=0, flat_w=flat,
                        ef=torch.zeros((self.k, self.d), device=self.device),
                        tcs_prev=flat)

    def client_grads(self, flat_w: Tensor, bx: Tensor, by: Tensor) -> Tensor:
        """Effective gradients ``g_k = −lr·∇ loss_k`` of every client's
        minibatch, [K, d] — one batched autograd pass over the model."""
        params = {n: p.detach()
                  for n, p in unflatten_lr(flat_w, self.pc).items()}

        def loss(p, x, y):
            logits = torch.func.functional_call(self.model, p, (x,))
            logp = torch.log_softmax(logits, dim=-1)
            return -torch.take_along_dim(logp, y[:, None], dim=1).mean()

        grads = torch.func.vmap(torch.func.grad(loss),
                                in_dims=(None, 0, 0))(params, bx, by)
        return -self.local_lr * torch.cat(
            [grads["w"].reshape(self.k, -1), grads["b"]], dim=1)

    def round_fn(self, state: SimState, plan: AggPlan,
                 participate: Optional[Tensor] = None, *,
                 batch_idx: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        """One round → ``(state, RoundLog)``.

        ``batch_idx`` ([K, batch]) replays given minibatch draws; otherwise
        they come from ``generator``.
        """
        bx, by = client_minibatch(self.fed, self.pc.batch_size, generator,
                                  idx=batch_idx)
        return self.aggregate_step(state, plan,
                                   self.client_grads(state.flat_w, bx, by),
                                   participate)

    def aggregate_step(self, state: SimState, plan: AggPlan, grads: Tensor,
                       participate: Optional[Tensor] = None):
        """Aggregate the clients' effective gradients ``grads`` [K, d] over
        ``plan`` and update the global model → ``(state, RoundLog)``."""
        pc, cfg = self.pc, self.agg
        global_mask = None
        tcs_prev = state.tcs_prev
        if cfg.kind in (AggKind.TC_SIA, AggKind.CL_TC_SIA):
            global_mask = tcs_mod.global_mask(
                tcs_mod.TCSState(tcs_prev), state.flat_w, cfg.q_global)
            tcs_prev = state.flat_w
        res = execute(cfg, plan, grads, state.ef, self.weights,
                      global_mask=global_mask, participate=participate)
        alive = torch.as_tensor(plan.alive, dtype=torch.float32,
                                device=self.device)
        part = alive if participate is None else participate * alive
        d_total = torch.clamp((self.weights * part).sum(), min=1e-9)
        flat_new = state.flat_w + res.aggregate / d_total
        new_state = SimState(round=state.round + 1, flat_w=flat_new,
                             ef=res.e_new, tcs_prev=tcs_prev)
        log = RoundLog(
            loss=lr_loss(unflatten_lr(flat_new, pc),
                         self.fed.x.reshape(-1, pc.input_dim),
                         self.fed.y.reshape(-1)),
            stats=(res.stats,), participation=part,
            ef_mass=banked_mass(res.e_new), stage_ef_mass=(),
            ef_dead_mass=dead_banked_mass(res.e_new, part))
        return new_state, log

    def run(self, rounds: int, *, seed: int = 0, eval_every: int = 10,
            test_x: Optional[Tensor] = None, test_y: Optional[Tensor] = None,
            participate_fn: Optional[Callable] = None,
            failure_schedule: Optional[FailureSchedule] = None,
            order_fn: Optional[Callable] = None,
            topology_schedule: Optional[TopologySchedule] = None,
            topology: Optional[Topology] = None) -> dict:
        """Train for ``rounds`` → dict of curves: ``loss``, ``bits`` and
        ``nnz`` per round (summed over the stages), ``accuracy`` as
        (round, acc) pairs every ``eval_every`` rounds and at the last,
        plus the final ``state``.

        ``participate_fn(r, state) -> [K]`` gives each round's straggler
        mask. Per-round topology sources (mutually exclusive, as in the
        reference):

        * ``failure_schedule`` (needs ``tree_topology``): relay deaths
          re-route the aggregation tree around the dead node, which is
          parked at the PS as an unreachable stub (``plan.alive`` zeros its
          participation); its banked EF mass transmits after recovery;
        * ``order_fn(r, state) -> [K]``: a permuted chain visiting order,
          compiled once per distinct order;
        * ``topology_schedule``: a :class:`~repro_torch.agg.TopologySchedule`
          whose plans share one padded ``(L, W)``;
        * ``topology``: one fixed topology (anything
          :func:`repro_torch.agg.compile_plan` takes, e.g. a ``star_tree``)
          — the port's own shorthand, taken alone.

        With none of them the round runs on ``tree_topology``'s tree, or on
        the paper's chain. Each distinct topology compiles once, at its own
        ``(L, W)``: the port has no trace to keep, so nothing is re-padded.
        Nothing is read back from the device until the last round has been
        issued.
        """
        plan_for = self._plan_source(failure_schedule, order_fn,
                                     topology_schedule, topology)
        gen = torch.Generator().manual_seed(seed)
        state = self.init()
        logs, accs = [], []
        for r in range(rounds):
            part = None
            if participate_fn is not None:
                part = torch.as_tensor(participate_fn(r, state),
                                       dtype=torch.float32,
                                       device=self.device)
            state, log = self.round_fn(state, plan_for(r, state), part,
                                       generator=gen)
            logs.append(log)
            if test_x is not None and (r % eval_every == 0
                                       or r == rounds - 1):
                params = unflatten_lr(state.flat_w, self.pc)
                accs.append((r, lr_accuracy(params, test_x.to(self.device),
                                            test_y.to(self.device))))
        return {"state": state,
                "loss": [float(log.loss) for log in logs],
                "bits": [float(sum(s.bits.sum() for s in log.stats))
                         for log in logs],
                "nnz": [float(sum(s.nnz_out.sum() for s in log.stats))
                        for log in logs],
                "accuracy": [(r, float(a)) for r, a in accs]}

    def _plan_source(self, failure_schedule, order_fn, topology_schedule,
                     topology) -> Callable[[int, SimState], AggPlan]:
        """The per-round plan of :meth:`run` and :meth:`run_batched`, after
        the reference's exclusivity checks; each distinct topology compiles
        once."""
        topo = self.tree_topology
        if topology is not None and (
                topo is not None or failure_schedule is not None
                or order_fn is not None or topology_schedule is not None):
            raise ValueError("topology is a fixed topology, taken alone: "
                             "not with tree_topology, failure_schedule, "
                             "order_fn or topology_schedule")
        if failure_schedule is not None and topo is None:
            raise ValueError("failure_schedule needs tree_topology (chain "
                             "failures go through participate_fn + order_fn)")
        if order_fn is not None and (topo is not None
                                     or topology_schedule is not None):
            raise ValueError("order_fn is a chain-mode knob; trees, nested "
                             "plans and schedules carry their own topology")
        if topology_schedule is not None and topo is not None:
            raise ValueError("pass either tree_topology/nested_topology or "
                             "topology_schedule, not both")
        plans: dict = {}

        def cached(key, build: Callable[[], Topology]) -> AggPlan:
            if key not in plans:
                plans[key] = compile_plan(build(), num_clients=self.k)
            return plans[key]

        def plan_for(r: int, state: SimState) -> AggPlan:
            if topology_schedule is not None:
                return topology_schedule.plan_at(r)
            if topology is not None:
                return cached(("fixed",), lambda: topology)
            if topo is not None:
                dead = (tuple(failure_schedule.dead_at(r))
                        if failure_schedule is not None else ())
                return cached(("tree", dead), lambda: topo.tree(dead=dead))
            if order_fn is not None:
                order = tuple(int(i) for i in order_fn(r, state))
                return cached(("order", order), lambda: list(order))
            return cached(("chain",), lambda: self.k)

        return plan_for

    # -- batched multi-tenant rounds ----------------------------------------

    def init_batched(self, seeds) -> SimState:
        """The state of ``len(seeds)`` cohorts: every leaf but the round
        counter stacked on a leading cohort axis. (The model starts at zero
        whatever the seed; the seeds seed each cohort's minibatch draws in
        :meth:`run_batched`.)"""
        states = [self.init() for _ in seeds]
        return SimState(round=0,
                        flat_w=torch.stack([s.flat_w for s in states]),
                        ef=torch.stack([s.ef for s in states]),
                        tcs_prev=torch.stack([s.tcs_prev for s in states]))

    def round_fn_batched(self, state: SimState, plan: AggPlan,
                         participate: Optional[Tensor] = None, *,
                         batch_idx: Optional[Tensor] = None,
                         generators=None):
        """One round of B cohorts → ``(state, RoundLog)`` with leaves
        ``[B, ...]``.

        ``batch_idx`` ([B, K, batch]) replays given minibatch draws;
        otherwise cohort i draws from ``generators[i]``. Each cohort's
        gradients are taken as its own round takes them (a batch of
        cohorts could sum the matrix products in another order); the
        aggregation runs all cohorts at once. ``plan`` is shared or
        stacked (:func:`repro_torch.agg.plan.stack_plans`);
        ``participate`` is ``[B, K]``.
        """
        grads = []
        for i in range(state.flat_w.shape[0]):
            bx, by = client_minibatch(
                self.fed, self.pc.batch_size,
                None if generators is None else generators[i],
                idx=None if batch_idx is None else batch_idx[i])
            grads.append(self.client_grads(state.flat_w[i], bx, by))
        return self.aggregate_step_batched(state, plan, torch.stack(grads),
                                           participate)

    def aggregate_step_batched(self, state: SimState, plan: AggPlan,
                               grads: Tensor,
                               participate: Optional[Tensor] = None):
        """:meth:`aggregate_step` for B cohorts: ``grads`` [B, K, d] →
        ``(state, RoundLog)`` with leaves ``[B, ...]``."""
        pc, cfg = self.pc, self.agg
        b, k = grads.shape[0], self.k
        global_mask = None
        tcs_prev = state.tcs_prev
        if cfg.kind in (AggKind.TC_SIA, AggKind.CL_TC_SIA):
            global_mask = torch.stack([
                tcs_mod.global_mask(tcs_mod.TCSState(prev), w, cfg.q_global)
                for prev, w in zip(tcs_prev, state.flat_w)])
            tcs_prev = state.flat_w
        weights = self.weights.expand(b, k)
        res = execute_batched(cfg, plan, grads, state.ef, weights,
                              global_mask=global_mask,
                              participate=participate)
        alive = torch.as_tensor(plan.alive, dtype=torch.float32,
                                device=self.device).expand(b, k)
        part = alive if participate is None else participate * alive
        d_total = torch.clamp((weights * part).sum(dim=1), min=1e-9)
        flat_new = state.flat_w + res.aggregate / d_total[:, None]
        new_state = SimState(round=state.round + 1, flat_w=flat_new,
                             ef=res.e_new, tcs_prev=tcs_prev)
        xs = self.fed.x.reshape(-1, pc.input_dim)
        ys = self.fed.y.reshape(-1)
        log = RoundLog(
            loss=torch.stack([lr_loss(unflatten_lr(w, pc), xs, ys)
                              for w in flat_new]),
            stats=(res.stats,), participation=part,
            ef_mass=banked_mass(res.e_new), stage_ef_mass=(),
            ef_dead_mass=dead_banked_mass(res.e_new, part))
        return new_state, log

    def run_batched(self, rounds: int, *, seeds, eval_every: int = 10,
                    test_x: Optional[Tensor] = None,
                    test_y: Optional[Tensor] = None,
                    participate_fn: Optional[Callable] = None,
                    failure_schedule: Optional[FailureSchedule] = None,
                    order_fn: Optional[Callable] = None,
                    topology_schedule: Optional[TopologySchedule] = None,
                    topology: Optional[Topology] = None,
                    collector=None) -> dict:
        """Train ``len(seeds)`` independent cohorts → per-cohort curves:
        ``{"state", "loss" [rounds][B], "bits" [rounds][B], "nnz"
        [rounds][B], "accuracy" [(round, [B])]}``.

        Cohort i draws its minibatches from a generator seeded by
        ``seeds[i]``, as ``run(seed=seeds[i])`` does, and gets that run's
        curves bit for bit. All cohorts share the constellation: the
        per-round topology sources are :meth:`run`'s, with its exclusivity
        errors, and ``participate_fn(r, state)`` may give one ``[K]`` mask
        for every cohort or a ``[B, K]`` one. Plans are flat: a nested
        topology raises ``ValueError``. Trace collection is not ported
        yet (``collector`` raises).
        """
        if collector is not None:
            raise NotImplementedError("run_batched(collector=) is not "
                                      "ported yet — ROADMAP A11")
        if isinstance(topology, NestedTopology):
            raise ValueError("batched rounds run flat plans; nested "
                             "topologies aggregate per cohort")
        plan_for = self._plan_source(failure_schedule, order_fn,
                                     topology_schedule, topology)
        seeds = [int(s) for s in seeds]
        b = len(seeds)
        gens = [torch.Generator().manual_seed(s) for s in seeds]
        state = self.init_batched(seeds)
        logs, accs = [], []
        for r in range(rounds):
            part = None
            if participate_fn is not None:
                part = torch.as_tensor(participate_fn(r, state),
                                       dtype=torch.float32,
                                       device=self.device)
                if part.dim() == 1:        # one mask for every cohort
                    part = part.expand(b, self.k)
            state, log = self.round_fn_batched(state, plan_for(r, state),
                                               part, generators=gens)
            logs.append(log)
            if test_x is not None and (r % eval_every == 0
                                       or r == rounds - 1):
                tx, ty = test_x.to(self.device), test_y.to(self.device)
                accs.append((r, torch.stack([
                    lr_accuracy(unflatten_lr(w, self.pc), tx, ty)
                    for w in state.flat_w])))
        rows = lambda f: [[float(v) for v in f(log).tolist()]  # noqa: E731
                          for log in logs]
        return {"state": state,
                "loss": rows(lambda log: log.loss),
                "bits": rows(lambda log: log.stats[0].bits.sum(dim=-1)),
                "nnz": rows(lambda log: log.stats[0].nnz_out.sum(dim=-1)),
                "accuracy": [(r, a.tolist()) for r, a in accs]}
