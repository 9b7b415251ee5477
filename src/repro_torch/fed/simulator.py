"""Multi-hop FL simulator — the paper's §VI experiment (port of
:mod:`repro.fed.simulator`).

K clients train a d = 7850 logistic-regression model on synthetic MNIST.
Per round:

  1. every client takes one SGD step on its local minibatch → effective
     gradient g_k = −lr·∇_k;
  2. the round's aggregation topology — the chain, a permuted chain via
     ``order_fn``, a routed constellation tree (``tree_topology``, re-routed
     around the dead relays of a ``failure_schedule``), a staged
     cluster-then-relay plan (``nested_topology``), a
     ``topology_schedule``, a fault ``scenario``, or any compiled
     :class:`~repro_torch.agg.AggPlan` — aggregates {D_k·g_k} with the
     configured Algorithm 1–5 (error feedback persists across rounds; a
     nested plan keeps one EF tier per upper stage in ``SimState.stage_ef``);
  3. the PS applies w ← w + γ_1 / D.

Rounds run on ``cuda`` unless the simulator is built with another
``device``; with no card and no ``device="cpu"`` construction raises.
``backend="device"`` runs the same rounds through the client-per-rank
lowering (:mod:`repro_torch.agg.device`: ``execute_sharded``,
``execute_sharded_batched``, ``execute_nested_sharded``) over a
:class:`~repro_torch.agg.device.ClientMesh` — one rank per client, every
rank's rows on its own device, bit for bit the host backend's rounds.
Minibatch draws come from a CPU ``torch.Generator`` seeded by
:meth:`Simulator.run`, or are passed in by the caller
(:meth:`Simulator.round_fn`'s ``batch_idx``), so a test can replay
another implementation's draws.

Round logs stay on the device and are read back once every
``flush_every`` rounds (and once at the end) through :func:`_fetch_logs`,
one device→host copy per flush; a
:class:`~repro_torch.obs.collector.TraceCollector` passed to :meth:`run`
writes each round to a ``repro.obs.trace/1.1`` JSONL trace from those
copies, so collection never changes what a round computes.

:meth:`Simulator.run_batched` trains B independent cohorts (one seed
each) over the same constellation: each round takes every cohort's
gradients as its own round would, then aggregates all B cohorts with one
level step per level (:func:`repro_torch.agg.plan.execute_batched`).
Cohort i of a batched run is ``run(seed=seeds[i])`` bit for bit.

Traces differ from the reference's in two fields only: the port compiles
each tree at its own ``(L, W)`` where the reference re-pads its plan cache
to a running maximum, so a round record's ``plan`` shape may differ on a
failure timeline; and ``retraces`` counts the distinct input signatures
the rounds met (:class:`~repro_torch.obs.collector.TraceCounter`), not jit
traces. Bits, nnz, loss, participation, EF masses and critical paths are
the reference's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.agg.device import (ClientMesh, client_mesh,
                                    execute_nested_sharded, execute_sharded,
                                    execute_sharded_batched)
from repro_torch.agg.nested import (NestedPlan, as_nested, compile_nested,
                                    execute_nested, zero_stage_ef)
from repro_torch.agg.plan import (AggPlan, Topology, compile_plan, execute,
                                  execute_batched)
from repro_torch.agg.schedule import TopologySchedule
from repro_torch.configs.paper_mnist import PaperConfig
from repro_torch.core import tcs as tcs_mod
from repro_torch.core.algorithms import AggConfig, AggKind, HopStats
from repro_torch.data.federated import FederatedData, client_minibatch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fed.topology import FailureSchedule, TreeTopology
from repro_torch.obs.collector import (RoundBuffer, TraceCounter,
                                       input_signature)
from repro_torch.obs.timing import PhaseTimer
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
    stage_ef: tuple = ()    # upper EF tiers ([K_s, d]) of a nested topology


class RoundLog(NamedTuple):
    """Per-round telemetry, with the reference's fields in its order.

    Leaves stay on the device until the run's next flush reads them
    (:func:`_fetch_logs`). ``stats`` holds the per-stage
    :class:`~repro_torch.core.algorithms.HopStats` (stage 0 = the client
    forest, leaves [K_s] in client index order; flat plans have that one
    stage), and ``stage_ef_mass`` the banked mass of each upper EF tier of a
    nested plan (none for flat plans).
    """

    loss: Tensor            # full-train-set loss after the update
    stats: tuple            # per-stage HopStats (§V exact per-hop bits)
    participation: Tensor   # [K] effective mask (participate ∧ alive)
    ef_mass: Tensor         # [K] ‖e_k‖₁ banked after this round
    stage_ef_mass: tuple    # banked mass per upper EF tier ([K_s] each)
    ef_dead_mass: Tensor    # Σ over non-participants of ‖e_k‖₁


def _fetch_logs(buffer: RoundBuffer) -> list:
    """The run loops' one device→host read-back point: every buffered
    round log copied to the CPU with one copy. Module-level so tests can
    wrap it to count reads."""
    return buffer.flush()


def _plan_signature(plan) -> tuple:
    """What a round's plan contributes to its input signature: flat or
    nested, the padded shape (per stage) and whether it carries budgets."""
    return (type(plan).__name__, plan.shape, plan.q_budget is None)


@dataclasses.dataclass
class Simulator:
    """Multi-hop FL simulator over any aggregation topology.

    The default topology is the paper's identity chain. ``tree_topology``
    routes a constellation graph instead; relay deaths from a
    ``failure_schedule`` passed to :meth:`run` re-route the tree (re-rooting
    the severed subtree through surviving ISLs). ``nested_topology`` (a
    :class:`~repro_torch.agg.nested.NestedPlan`, a routed
    ``NestedTopology`` from :func:`repro_torch.topo.routing.cluster_routed`,
    or a ``compile_nested`` stage spec) runs every round through
    :func:`~repro_torch.agg.nested.execute_nested`, with the upper EF tiers
    in ``SimState.stage_ef``.

    ``trace_counter`` counts the distinct input signatures the rounds
    meet (state shapes, plan kind and padded shape, participation given
    or not) — the port's counterpart of the reference's jit trace count.

    ``backend`` is ``"host"`` (:func:`~repro_torch.agg.plan.execute` on
    ``device``) or ``"device"`` (the client-per-rank lowering over
    ``mesh``; ``mesh=None`` is :func:`~repro_torch.agg.device.client_mesh`
    over K CUDA devices, which raises with fewer cards — pass
    ``client_mesh(K, devices=["cuda:0"] * K)`` to put every rank on one).
    Results come back on ``device`` either way.
    """

    pc: PaperConfig
    agg: AggConfig
    fed: FederatedData
    local_lr: float = 0.1
    tree_topology: Optional[TreeTopology] = None
    nested_topology: Optional[Any] = None
    device: DeviceLike = None
    backend: str = "host"
    mesh: Optional[ClientMesh] = None

    def __post_init__(self):
        if self.backend not in ("host", "device"):
            raise ValueError(f"unknown backend {self.backend!r}")
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
        self._nested = None
        if self.nested_topology is not None:
            if self.tree_topology is not None:
                raise ValueError("pass either tree_topology or "
                                 "nested_topology, not both")
            self._nested = (self.nested_topology
                            if isinstance(self.nested_topology, NestedPlan)
                            else compile_nested(self.nested_topology,
                                                num_clients=self.k))
            if self._nested.num_clients != self.k:
                raise ValueError(
                    f"nested topology has {self._nested.num_clients} "
                    f"clients, data has {self.k}")
        if self.backend == "device":
            self.mesh = (client_mesh(self.k) if self.mesh is None
                         else self.mesh)
            if self.mesh.size != self.k:
                raise ValueError(f"mesh has {self.mesh.size} ranks, data "
                                 f"has {self.k} clients")
        elif self.mesh is not None:
            raise ValueError("a mesh is taken only with backend='device'")
        self.trace_counter = TraceCounter()

    def init(self) -> SimState:
        flat = flatten_lr(lr_init(self.pc, self.device))
        stage_ef = (() if self._nested is None
                    else zero_stage_ef(self._nested, self.d, self.device))
        return SimState(round=0, flat_w=flat,
                        ef=torch.zeros((self.k, self.d), device=self.device),
                        tcs_prev=flat, stage_ef=stage_ef)

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

    def round_fn(self, state: SimState, plan,
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

    def aggregate_step(self, state: SimState, plan, grads: Tensor,
                       participate: Optional[Tensor] = None):
        """Aggregate the clients' effective gradients ``grads`` [K, d] over
        ``plan`` (flat or nested) and update the global model →
        ``(state, RoundLog)``.

        A nested plan met by a state without EF tiers (a schedule of nested
        plans) starts them at zero, as the reference's run does."""
        pc, cfg = self.pc, self.agg
        nested = isinstance(plan, NestedPlan)
        if nested and not state.stage_ef:
            state = state._replace(stage_ef=zero_stage_ef(plan, self.d,
                                                          self.device))
        self.trace_counter.observe(input_signature(
            state.flat_w, state.ef, *state.stage_ef, participate)
            + (_plan_signature(plan),))
        global_mask = None
        tcs_prev = state.tcs_prev
        if cfg.kind in (AggKind.TC_SIA, AggKind.CL_TC_SIA):
            global_mask = tcs_mod.global_mask(
                tcs_mod.TCSState(tcs_prev), state.flat_w, cfg.q_global)
            tcs_prev = state.flat_w
        dev_kw = {} if self.backend == "host" else {"mesh": self.mesh}
        if nested:
            run_nested = (execute_nested if self.backend == "host"
                          else execute_nested_sharded)
            res = run_nested(cfg, plan, grads, state.ef, self.weights,
                             stage_e=state.stage_ef, global_mask=global_mask,
                             participate=participate, **dev_kw)
            stage_ef = res.stage_e_new
            all_stats = (res.stats,) + res.stage_stats
            # whole-chain aliveness: a stub cluster's clients forward
            # nothing to the PS, so they leave the denominator too
            alive = plan.client_alive(self.device)
        else:
            run_flat = (execute if self.backend == "host"
                        else execute_sharded)
            res = run_flat(cfg, plan, grads, state.ef, self.weights,
                           global_mask=global_mask, participate=participate,
                           **dev_kw)
            stage_ef = state.stage_ef
            all_stats = (res.stats,)
            alive = torch.as_tensor(plan.alive, dtype=torch.float32,
                                    device=self.device)
        part = alive if participate is None else participate * alive
        d_total = torch.clamp((self.weights * part).sum(), min=1e-9)
        flat_new = state.flat_w + res.aggregate / d_total
        new_state = SimState(round=state.round + 1, flat_w=flat_new,
                             ef=res.e_new, tcs_prev=tcs_prev,
                             stage_ef=stage_ef)
        log = RoundLog(
            loss=lr_loss(unflatten_lr(flat_new, pc),
                         self.fed.x.reshape(-1, pc.input_dim),
                         self.fed.y.reshape(-1)),
            stats=all_stats, participation=part,
            ef_mass=banked_mass(res.e_new),
            stage_ef_mass=tuple(banked_mass(e) for e in stage_ef),
            ef_dead_mass=dead_banked_mass(res.e_new, part))
        return new_state, log

    def _topology_name(self, compiled, failure_schedule, order_fn,
                       topology_schedule, topology) -> str:
        """The trace meta's ``topology``: the reference's names, and
        ``"fixed"`` for the port's ``topology=`` shorthand."""
        if compiled is not None:
            return "scenario"
        if self._nested is not None:
            return "nested"
        if topology_schedule is not None:
            return "schedule"
        if self.tree_topology is not None:
            return "tree"
        if order_fn is not None:
            return "order"
        return "fixed" if topology is not None else "chain"

    def run(self, rounds: int, *, seed: int = 0, eval_every: int = 10,
            test_x: Optional[Tensor] = None, test_y: Optional[Tensor] = None,
            participate_fn: Optional[Callable] = None,
            failure_schedule: Optional[FailureSchedule] = None,
            order_fn: Optional[Callable] = None,
            topology_schedule: Optional[TopologySchedule] = None,
            topology: Optional[Topology] = None,
            scenario=None, collector=None, flush_every: int = 32) -> dict:
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
          whose plans share one padded shape (flat or nested);
        * ``scenario``: a :class:`repro_torch.scenario.Scenario` (compiled
          here) or a :class:`repro_torch.scenario.CompiledScenario` — its
          schedule and realized participation drive every round, the seed
          is pinned to the spec's ``seed``, and the spec and its realized
          events go into the trace (meta ``scenario_spec``, spans on the
          ``scenario`` track), so the run replays from the spec or from its
          own trace; taken alone;
        * ``topology``: one fixed topology (anything
          :func:`repro_torch.agg.compile_plan` takes, e.g. a ``star_tree``,
          or a nested one) — the port's own shorthand, taken alone.

        With none of them the round runs on ``nested_topology``'s plan,
        ``tree_topology``'s tree, or the paper's chain. Each distinct
        topology compiles once, at its own shape: the port has no trace to
        keep, so nothing is re-padded.

        ``collector`` (a :class:`repro_torch.obs.TraceCollector`) records
        every round. Round logs stay on the device and are read back with
        one copy every ``flush_every`` rounds (and once at the end); the
        curves do not depend on the cadence or on the collector.
        """
        compiled = None
        if scenario is not None:
            if (participate_fn is not None or failure_schedule is not None
                    or order_fn is not None or topology_schedule is not None
                    or topology is not None
                    or self.tree_topology is not None
                    or self._nested is not None):
                raise ValueError("a scenario carries its own topology and "
                                 "participation — pass it alone")
            from repro_torch.scenario.compile import (CompiledScenario,
                                                      compile_scenario)
            compiled = (scenario if isinstance(scenario, CompiledScenario)
                        else compile_scenario(scenario, cfg=self.agg))
            if compiled.num_clients != self.k:
                raise ValueError(f"scenario has {compiled.num_clients} "
                                 f"clients, data has {self.k}")
            # replay determinism: the data stream is pinned by the spec,
            # not the call site
            seed = compiled.spec.seed
            topology_schedule = compiled.schedule
        plan_for = self._plan_source(failure_schedule, order_fn,
                                     topology_schedule, topology)
        if collector is not None:
            extra = {}
            if compiled is not None:
                # the full spec rides in the trace meta: a recorded trace is
                # enough to re-run its scenario (scenario_from_trace)
                extra = {"scenario": compiled.spec.name,
                         "scenario_spec": compiled.spec.to_dict()}
            collector.configure(
                cfg=self.agg, d=self.d, num_clients=self.k,
                backend=self.backend,
                device=str(self.device),
                topology=self._topology_name(compiled, failure_schedule,
                                             order_fn, topology_schedule,
                                             topology), **extra)
            if compiled is not None:
                # realized event stream → spans on the scenario track
                # (t0_s/dur_s are in *rounds*, not seconds)
                for ev in compiled.events:
                    collector.record_span(
                        ev["name"], float(ev["round"]), float(ev["rounds"]),
                        track="scenario",
                        args={"kind": ev["kind"], **(ev.get("args") or {})})

        gen = torch.Generator().manual_seed(seed)
        state = self.init()
        timer = PhaseTimer()
        buf = RoundBuffer()
        pending: list = []      # (round, plan, tree, retraces, phases)
        accs, losses, bits, nnzs = [], [], [], []
        run_t0 = time.perf_counter()

        def flush():
            t0 = time.perf_counter()
            logs = _fetch_logs(buf)
            dur = time.perf_counter() - t0
            if collector is not None and logs:
                collector.record_span("flush", t0 - run_t0, dur,
                                      track="simulator",
                                      args={"rounds": len(logs)})
            for (log, acc), (r, plan, tree, retraces, phases) in zip(
                    logs, pending):
                losses.append(float(log.loss))
                bits.append(float(sum(s.bits.sum() for s in log.stats)))
                nnzs.append(float(sum(s.nnz_out.sum() for s in log.stats)))
                if acc is not None:
                    accs.append((r, float(acc)))
                if collector is not None:
                    collector.record_round(
                        r, log.stats, plan=plan, tree=tree, loss=log.loss,
                        participate=log.participation, ef_mass=log.ef_mass,
                        stage_ef_mass=log.stage_ef_mass,
                        ef_dead_mass=log.ef_dead_mass, retraces=retraces,
                        phases=phases)
            del pending[:]

        for r in range(rounds):
            with timer.phase("plan"):
                plan, tree = plan_for(r, state)
                part = None
                if compiled is not None:
                    part = compiled.participate_at(r)
                elif participate_fn is not None:
                    part = participate_fn(r, state)
                if part is not None:
                    part = torch.as_tensor(part, dtype=torch.float32,
                                           device=self.device)
            with timer.phase("dispatch"):
                state, log = self.round_fn(state, plan, part, generator=gen)
                acc = None
                if test_x is not None and (r % eval_every == 0
                                           or r == rounds - 1):
                    acc = lr_accuracy(unflatten_lr(state.flat_w, self.pc),
                                      test_x.to(self.device),
                                      test_y.to(self.device))
            # logs stay on the device until the next flush
            buf.push((log, acc))
            pending.append((r, plan, tree, self.trace_counter.count,
                            timer.take()))
            if len(buf) >= max(1, flush_every):
                flush()
        flush()
        return {"state": state, "loss": losses, "bits": bits, "nnz": nnzs,
                "accuracy": accs}

    def _plan_source(self, failure_schedule, order_fn, topology_schedule,
                     topology) -> Callable[[int, SimState], tuple]:
        """The per-round ``(plan, routed tree or None)`` of :meth:`run` and
        :meth:`run_batched`, after the reference's exclusivity checks; the
        tree is the link model of the trace's timeline. Each distinct
        topology compiles once."""
        topo = self.tree_topology
        nested = self._nested
        if topology is not None and (
                topo is not None or nested is not None
                or failure_schedule is not None or order_fn is not None
                or topology_schedule is not None):
            raise ValueError("topology is a fixed topology, taken alone: "
                             "not with tree_topology, nested_topology, "
                             "failure_schedule, order_fn or "
                             "topology_schedule")
        if failure_schedule is not None and topo is None:
            raise ValueError("failure_schedule needs tree_topology (chain "
                             "failures go through participate_fn + order_fn)")
        if order_fn is not None and (topo is not None or nested is not None
                                     or topology_schedule is not None):
            raise ValueError("order_fn is a chain-mode knob; trees, nested "
                             "plans and schedules carry their own topology")
        if topology_schedule is not None and (topo is not None
                                              or nested is not None):
            raise ValueError("pass either tree_topology/nested_topology or "
                             "topology_schedule, not both")
        plans: dict = {}

        def cached(key, build: Callable[[], Topology]) -> tuple:
            if key not in plans:
                raw = build()
                plan = as_nested(raw, self.k)
                if plan is None:
                    plan = compile_plan(raw, num_clients=self.k)
                plans[key] = (plan, raw if hasattr(raw, "uplink_bw_bps")
                              else None)
            return plans[key]

        def plan_for(r: int, state: SimState) -> tuple:
            if nested is not None:
                return nested, None
            if topology_schedule is not None:
                raw = topology_schedule.raw_at(r)
                return (topology_schedule.plan_at(r),
                        raw if hasattr(raw, "uplink_bw_bps") else None)
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

    def _refuse_nested(self, topology, topology_schedule) -> None:
        if (self._nested is not None or as_nested(topology) is not None
                or (topology_schedule is not None and len(topology_schedule)
                    and isinstance(topology_schedule.plan_at(0),
                                   NestedPlan))):
            raise ValueError("batched rounds run flat plans; nested "
                             "topologies aggregate per cohort")

    def init_batched(self, seeds) -> SimState:
        """The state of ``len(seeds)`` cohorts: every leaf but the round
        counter stacked on a leading cohort axis. (The model starts at zero
        whatever the seed; the seeds seed each cohort's minibatch draws in
        :meth:`run_batched`.)"""
        self._refuse_nested(None, None)
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
        self.trace_counter.observe(input_signature(
            state.flat_w, state.ef, participate) + (_plan_signature(plan),))
        global_mask = None
        tcs_prev = state.tcs_prev
        if cfg.kind in (AggKind.TC_SIA, AggKind.CL_TC_SIA):
            global_mask = torch.stack([
                tcs_mod.global_mask(tcs_mod.TCSState(prev), w, cfg.q_global)
                for prev, w in zip(tcs_prev, state.flat_w)])
            tcs_prev = state.flat_w
        weights = self.weights.expand(b, k)
        if self.backend == "host":
            res = execute_batched(cfg, plan, grads, state.ef, weights,
                                  global_mask=global_mask,
                                  participate=participate)
        else:
            res = execute_sharded_batched(cfg, plan, grads, state.ef,
                                          weights, mesh=self.mesh,
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
                    collector=None, flush_every: int = 32) -> dict:
        """Train ``len(seeds)`` independent cohorts → per-cohort curves:
        ``{"state", "loss" [rounds][B], "bits" [rounds][B], "nnz"
        [rounds][B], "accuracy" [(round, [B])]}``.

        Cohort i draws its minibatches from a generator seeded by
        ``seeds[i]``, as ``run(seed=seeds[i])`` does, and gets that run's
        curves bit for bit. All cohorts share the constellation: the
        per-round topology sources are :meth:`run`'s, with its exclusivity
        errors, and ``participate_fn(r, state)`` may give one ``[K]`` mask
        for every cohort or a ``[B, K]`` one. Plans are flat: a nested
        topology raises ``ValueError``. ``collector`` records one round
        record per cohort per round, tagged ``cohort=i``; logs are read
        back once per ``flush_every`` rounds, as in :meth:`run`.
        """
        self._refuse_nested(topology, topology_schedule)
        plan_for = self._plan_source(failure_schedule, order_fn,
                                     topology_schedule, topology)
        seeds = [int(s) for s in seeds]
        b = len(seeds)
        if collector is not None:
            collector.configure(
                cfg=self.agg, d=self.d, num_clients=self.k,
                backend=self.backend,
                device=str(self.device), cohorts=b,
                topology=self._topology_name(None, failure_schedule,
                                             order_fn, topology_schedule,
                                             topology))
        gens = [torch.Generator().manual_seed(s) for s in seeds]
        state = self.init_batched(seeds)
        timer = PhaseTimer()
        buf = RoundBuffer()
        pending: list = []
        accs, losses, bits, nnzs = [], [], [], []
        run_t0 = time.perf_counter()
        rows = lambda x: [float(v) for v in x.tolist()]  # noqa: E731

        def flush():
            t0 = time.perf_counter()
            logs = _fetch_logs(buf)
            dur = time.perf_counter() - t0
            if collector is not None and logs:
                collector.record_span("flush", t0 - run_t0, dur,
                                      track="simulator",
                                      args={"rounds": len(logs)})
            for (log, acc), (r, plan, tree, retraces, phases) in zip(
                    logs, pending):
                st0 = log.stats[0]
                losses.append(rows(log.loss))
                bits.append(rows(st0.bits.sum(dim=-1)))
                nnzs.append(rows(st0.nnz_out.sum(dim=-1)))
                if acc is not None:
                    accs.append((r, acc.tolist()))
                if collector is not None:
                    for i in range(b):
                        collector.record_round(
                            r, HopStats(*(x[i] for x in st0)), plan=plan,
                            tree=tree, loss=log.loss[i],
                            participate=log.participation[i],
                            ef_mass=log.ef_mass[i],
                            ef_dead_mass=log.ef_dead_mass[i],
                            retraces=retraces, phases=phases, cohort=i)
            del pending[:]

        for r in range(rounds):
            with timer.phase("plan"):
                plan, tree = plan_for(r, state)
                part = None
                if participate_fn is not None:
                    part = torch.as_tensor(participate_fn(r, state),
                                           dtype=torch.float32,
                                           device=self.device)
                    if part.dim() == 1:        # one mask for every cohort
                        part = part.expand(b, self.k)
            with timer.phase("dispatch"):
                state, log = self.round_fn_batched(state, plan, part,
                                                   generators=gens)
                acc = None
                if test_x is not None and (r % eval_every == 0
                                           or r == rounds - 1):
                    tx, ty = test_x.to(self.device), test_y.to(self.device)
                    acc = torch.stack([
                        lr_accuracy(unflatten_lr(w, self.pc), tx, ty)
                        for w in state.flat_w])
            buf.push((log, acc))
            pending.append((r, plan, tree, self.trace_counter.count,
                            timer.take()))
            if len(buf) >= max(1, flush_every):
                flush()
        flush()
        return {"state": state, "loss": losses, "bits": bits, "nnz": nnzs,
                "accuracy": accs}
