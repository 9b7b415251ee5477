"""The declarative scenario schema (dataclasses + dict/JSON round-trip;
port of :mod:`repro.scenario.spec`, the same schema and file format).

A :class:`Scenario` is a complete, self-contained description of a
fault-injection experiment: the base constellation (a
:class:`TopologySpec` naming a ``repro_torch.topo.graph`` builder), the
aggregation algorithm, and a set of fault timelines —

* :class:`LinkFlap` — a link outage window, one-shot or periodic
  (ephemeris-like: the link is down for ``down`` consecutive rounds out
  of every ``period``, an orbital-occlusion schedule);
* :class:`Crash` — a client/relay death at a round, with optional
  recovery (the scenario compiler routes around the dead node, so its
  subtree re-roots through surviving ISLs);
* :class:`StragglerWindow` — a window during which participation is
  drawn from :class:`repro_torch.runtime.fault.StragglerModel` under a
  dedicated seed stream (a ``torch.Generator`` per round, seeded from the
  window's ``seed`` and the round), optionally correlated round-to-round;
* :class:`BandwidthRamp` — a linear bandwidth-degradation ramp on a set
  of links (re-routing and, with ``bandwidth_aware``, per-client Top-Q
  budgets follow the shrinking links);
* :class:`DeadlineWindow` — a per-round deadline over
  :class:`repro_torch.fed.topology.LatencyModel` draws
  (:func:`repro_torch.runtime.fault.deadline_mask` participation).

Everything stochastic carries its own seed and every timeline is a pure
function of the round index, so a spec realizes the same event stream on
every compile — the determinism replay rests on. ``to_dict``/``from_dict``
round-trip through JSON-safe types (tuples normalize in both directions);
:func:`scenario_from_trace` recovers the spec a simulator run embedded in
its trace meta record, closing the record→replay loop.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

#: Versioned spec schema tag (bump the suffix on incompatible changes).
SPEC_SCHEMA = "repro.scenario/1"


def _link(uv) -> tuple:
    u, v = int(uv[0]), int(uv[1])
    return (min(u, v), max(u, v))


def _in_window(r: int, start: int, end: Optional[int]) -> bool:
    return r >= start and (end is None or r < end)


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Base constellation: a named ``repro_torch.topo.graph`` builder + routing.

    ``kind``: ``chain`` (the paper's linear chain — crashes heal by
    splicing, :func:`repro_torch.topo.routing.healed_chain_tree`), ``star``,
    ``grid``, ``walker_delta``, ``walker_star``, or ``geometric``;
    ``params`` are the builder's keyword arguments. ``routing`` picks the
    spanning-tree policy (``latency``/``hops``/``widest``); ``clusters``
    switches to staged aggregation via
    :func:`repro_torch.topo.routing.cluster_routed` (the partition is computed
    once on the base graph and held fixed, so every round's
    :class:`~repro_torch.agg.nested.NestedPlan` shares one per-stage shape).
    """

    kind: str = "chain"
    clients: int = 8
    params: dict = dataclasses.field(default_factory=dict)
    routing: str = "latency"
    clusters: Optional[int] = None

    def __post_init__(self):
        if self.routing not in ("latency", "hops", "widest"):
            raise ValueError(f"unknown routing {self.routing!r}")

    def build(self):
        """→ the base :class:`~repro_torch.topo.graph.ConstellationGraph`."""
        from repro_torch.topo import graph as tg
        p = dict(self.params)
        if self.kind in ("chain", "path"):
            return tg.path_graph(self.clients, **p)
        if self.kind == "star":
            return tg.star_graph(self.clients, **p)
        if self.kind == "grid":
            rows = int(p.pop("rows", 2))
            cols = int(p.pop("cols", max(1, self.clients // 2)))
            return tg.grid_graph(rows, cols, **p)
        if self.kind in ("walker_delta", "walker_star"):
            planes = int(p.pop("num_planes", 2))
            sats = int(p.pop("sats_per_plane", max(2, self.clients // 2)))
            if "gateways" in p:
                p["gateways"] = tuple(int(g) for g in p["gateways"])
            builder = (tg.walker_delta if self.kind == "walker_delta"
                       else tg.walker_star)
            return builder(planes, sats, **p)
        if self.kind == "geometric":
            return tg.random_geometric(self.clients, **p)
        raise ValueError(f"unknown topology kind {self.kind!r}")

    @property
    def num_clients(self) -> int:
        if self.kind == "grid":
            return (int(self.params.get("rows", 2))
                    * int(self.params.get("cols",
                                          max(1, self.clients // 2))))
        if self.kind in ("walker_delta", "walker_star"):
            return (int(self.params.get("num_planes", 2))
                    * int(self.params.get("sats_per_plane",
                                          max(2, self.clients // 2))))
        return self.clients


@dataclasses.dataclass(frozen=True)
class LinkFlap:
    """Link outage: one-shot (``period=None``) or a periodic window.

    ``link`` is a graph-node pair (canonicalized u < v). Periodic flaps
    model ephemeris windows: starting at ``start``, the link is down for
    the first ``down`` rounds of every ``period``-round cycle.
    """

    link: tuple
    start: int = 0
    down: int = 1
    period: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "link", _link(self.link))
        if self.down < 1:
            raise ValueError("down must be >= 1 round")
        if self.period is not None and self.period < self.down:
            raise ValueError("period must cover the down window")

    def is_down(self, r: int) -> bool:
        if r < self.start:
            return False
        if self.period is None:
            return r < self.start + self.down
        return (r - self.start) % self.period < self.down


@dataclasses.dataclass(frozen=True)
class Crash:
    """Client/relay death at round ``round``; ``recover=None`` = stays
    dead. ``node`` is a *client index* (the simulator's [K, d] row)."""

    node: int
    round: int
    recover: Optional[int] = None

    def __post_init__(self):
        if self.recover is not None and self.recover <= self.round:
            raise ValueError("recover must come after the crash")

    def is_dead(self, r: int) -> bool:
        return _in_window(r, self.round, self.recover)


@dataclasses.dataclass(frozen=True)
class StragglerWindow:
    """Straggler burst: :class:`~repro_torch.runtime.fault.StragglerModel`
    draws inside ``[start, end)`` under a dedicated seed stream
    (:func:`repro_torch.scenario.compile.straggler_generator`)."""

    p_straggle: float
    start: int = 0
    end: Optional[int] = None
    correlated: bool = False
    p_recover: float = 0.5
    seed: int = 0

    def active(self, r: int) -> bool:
        return _in_window(r, self.start, self.end)

    def model(self):
        from repro_torch.runtime.fault import StragglerModel
        return StragglerModel(p_straggle=self.p_straggle,
                              correlated=self.correlated,
                              p_recover=self.p_recover)


@dataclasses.dataclass(frozen=True)
class BandwidthRamp:
    """Linear bandwidth degradation on ``links`` (None = every link).

    The multiplier ramps 1 → ``floor`` over ``[start, end)``, holds at
    ``floor``, and snaps back at ``recover`` (None = degraded forever).
    Factors are quantized to 1e-3 so a long ramp compiles a bounded
    number of distinct topologies.
    """

    start: int
    end: int
    floor: float = 0.1
    links: Optional[tuple] = None
    recover: Optional[int] = None

    def __post_init__(self):
        if self.end <= self.start:
            raise ValueError("ramp window must be non-empty")
        if not 0.0 < self.floor <= 1.0:
            raise ValueError("floor must be in (0, 1]")
        if self.links is not None:
            object.__setattr__(self, "links",
                               tuple(_link(uv) for uv in self.links))

    def factor(self, r: int) -> float:
        if r < self.start or (self.recover is not None
                              and r >= self.recover):
            return 1.0
        if r >= self.end:
            return self.floor
        frac = (r - self.start) / (self.end - self.start)
        return round(1.0 + frac * (self.floor - 1.0), 3)


@dataclasses.dataclass(frozen=True)
class DeadlineWindow:
    """Deadline-based participation over log-normal latency draws
    (:class:`repro_torch.fed.topology.LatencyModel`) inside ``[start, end)``."""

    deadline_s: float
    start: int = 0
    end: Optional[int] = None
    mean_s: float = 1.0
    sigma: float = 0.5
    seed: int = 0

    def active(self, r: int) -> bool:
        return _in_window(r, self.start, self.end)


_FAULT_TYPES = {"link_flaps": LinkFlap, "crashes": Crash,
                "stragglers": StragglerWindow, "ramps": BandwidthRamp,
                "deadlines": DeadlineWindow}


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One declarative fault-injection scenario (see module doc).

    ``agg`` holds :class:`~repro_torch.core.algorithms.AggConfig` keyword
    arguments (``kind`` as the string enum value); ``bandwidth_aware``
    attaches per-round :func:`repro_torch.agg.bandwidth_budgets` Top-Q budgets
    that follow the (possibly degraded) link bandwidths. ``seed`` drives
    the simulator's model/data stream — fault streams carry their own
    seeds — so one integer pins the whole run.
    """

    name: str
    rounds: int
    topology: TopologySpec
    seed: int = 0
    agg: Optional[dict] = None
    bandwidth_aware: bool = False
    link_flaps: tuple = ()
    crashes: tuple = ()
    stragglers: tuple = ()
    ramps: tuple = ()
    deadlines: tuple = ()

    def __post_init__(self):
        if self.rounds < 1:
            raise ValueError("scenario needs >= 1 round")
        for field, typ in _FAULT_TYPES.items():
            vals = tuple(v if isinstance(v, typ) else typ(**v)
                         for v in getattr(self, field))
            object.__setattr__(self, field, vals)
        if self.topology.kind in ("chain", "path") and (
                self.link_flaps or self.ramps):
            raise ValueError(
                "chain scenarios heal by splicing and have no link model — "
                "use a graph topology (grid/walker/...) for link-level "
                "faults")

    @property
    def num_clients(self) -> int:
        return self.topology.num_clients

    def agg_config(self):
        """→ the :class:`~repro_torch.core.algorithms.AggConfig` to run under."""
        from repro_torch.core.algorithms import AggConfig, AggKind
        kw = dict(self.agg or {})
        if "kind" in kw:
            kw["kind"] = AggKind(kw["kind"])
        return AggConfig(**kw)

    # -- dict / JSON round-trip ---------------------------------------------

    def to_dict(self) -> dict:
        out = {"schema": SPEC_SCHEMA, "name": self.name,
               "rounds": self.rounds, "seed": self.seed,
               "topology": dataclasses.asdict(self.topology),
               "bandwidth_aware": self.bandwidth_aware}
        if self.agg is not None:
            out["agg"] = dict(self.agg)
        faults = {field: [dataclasses.asdict(v)
                          for v in getattr(self, field)]
                  for field in _FAULT_TYPES if getattr(self, field)}
        if faults:
            out["faults"] = faults
        return out

    @classmethod
    def from_dict(cls, obj: dict) -> "Scenario":
        schema = obj.get("schema", SPEC_SCHEMA)
        if schema.split("/")[0] != SPEC_SCHEMA.split("/")[0]:
            raise ValueError(f"unknown scenario schema {schema!r}")
        topo = dict(obj["topology"])
        faults = obj.get("faults", {})
        kw = {field: tuple(typ(**v) for v in faults.get(field, ()))
              for field, typ in _FAULT_TYPES.items()}
        return cls(name=obj["name"], rounds=int(obj["rounds"]),
                   seed=int(obj.get("seed", 0)),
                   topology=TopologySpec(**topo),
                   agg=obj.get("agg"),
                   bandwidth_aware=bool(obj.get("bandwidth_aware", False)),
                   **kw)

    def to_json(self, path: Optional[str] = None) -> str:
        text = json.dumps(self.to_dict(), indent=1, sort_keys=True) + "\n"
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    @classmethod
    def from_json(cls, path: str) -> "Scenario":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def scenario_from_trace(path: str) -> tuple:
    """Recover ``(Scenario, meta record)`` from an emitted trace.

    A simulator run with ``scenario=`` embeds the full spec dict in the
    trace's meta record (``scenario_spec``), so a trace is sufficient to
    re-run its scenario bit-exactly — no separate spec file needed.
    """
    from repro_torch.obs.record import iter_trace
    for rec in iter_trace(path):
        if rec.get("kind") == "meta":
            spec = rec.get("scenario_spec")
            if spec is None:
                raise ValueError(f"{path}: trace was not recorded under a "
                                 f"scenario (no scenario_spec in meta)")
            return Scenario.from_dict(spec), rec
    raise ValueError(f"{path}: no meta record")
