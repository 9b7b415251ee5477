"""Built-in scenario presets (port of :mod:`repro.scenario.presets`; all
sized K = 8, as the reference sizes them).

* ``relay-cascade`` — the paper's chain under cascading relay deaths: three
  staggered crashes (one recovers), each splicing the chain around the gap
  while the dead client's banked EF mass waits for recovery.
* ``orbital-eclipse`` — a 2×4 Walker-delta shell whose inter-plane ISLs
  drop on staggered ephemeris windows (periodic link flaps), forcing
  per-window re-routes that all share one padded plan shape.
* ``uplink-degradation`` — a 2×4 ISL grid with heterogeneous-uplink rain
  fade: bandwidth ramps on the ground link and a mid-grid ISL under
  widest-path routing with bandwidth-aware Top-Q budgets, so narrow links
  shed §V bits as they degrade.
* ``straggler-storm`` — the chain under a correlated straggler burst plus
  a deadline window over log-normal latencies; participation collapses and
  recovers, EF conservation carries the banked mass through.

Each entry is a zero-argument factory so ``preset(name)`` always returns a
fresh, unshared :class:`~repro_torch.scenario.spec.Scenario`.
"""

from __future__ import annotations

from repro_torch.scenario.spec import (BandwidthRamp, Crash, DeadlineWindow,
                                 LinkFlap, Scenario, StragglerWindow,
                                 TopologySpec)


def relay_cascade() -> Scenario:
    return Scenario(
        name="relay-cascade", rounds=24, seed=0,
        topology=TopologySpec(kind="chain", clients=8),
        crashes=(Crash(node=5, round=4),
                 Crash(node=2, round=8, recover=16),
                 Crash(node=6, round=12)))


def orbital_eclipse() -> Scenario:
    # walker_delta(2, 4): sat j of plane p is node 1 + p*4 + j; the
    # inter-plane ISLs (1+j, 5+j) occlude on staggered 12-round periods
    return Scenario(
        name="orbital-eclipse", rounds=24, seed=0,
        topology=TopologySpec(kind="walker_delta", clients=8,
                              params={"num_planes": 2, "sats_per_plane": 4,
                                      "gateways": [1, 5]}),
        link_flaps=(LinkFlap(link=(1, 5), start=2, down=3, period=12),
                    LinkFlap(link=(2, 6), start=5, down=3, period=12),
                    LinkFlap(link=(3, 7), start=8, down=3, period=12),
                    LinkFlap(link=(0, 5), start=10, down=4)))


def uplink_degradation() -> Scenario:
    # grid_graph(2, 4): PS uplinks to node 1; ramps hit the ground link and
    # a mid-grid ISL, budgets follow via bandwidth_aware widest-path routing
    return Scenario(
        name="uplink-degradation", rounds=20, seed=0,
        topology=TopologySpec(kind="grid", clients=8,
                              params={"rows": 2, "cols": 4},
                              routing="widest"),
        bandwidth_aware=True,
        ramps=(BandwidthRamp(start=4, end=12, floor=0.2, recover=16,
                             links=((0, 1),)),
               BandwidthRamp(start=6, end=10, floor=0.5,
                             links=((2, 3), (6, 7)))))


def straggler_storm() -> Scenario:
    return Scenario(
        name="straggler-storm", rounds=24, seed=0,
        topology=TopologySpec(kind="chain", clients=8),
        stragglers=(StragglerWindow(p_straggle=0.4, start=6, end=18,
                                    correlated=True, p_recover=0.5, seed=3),),
        deadlines=(DeadlineWindow(deadline_s=1.6, start=10, end=14,
                                  mean_s=1.0, sigma=0.5, seed=7),))


PRESETS = {
    "relay-cascade": relay_cascade,
    "orbital-eclipse": orbital_eclipse,
    "uplink-degradation": uplink_degradation,
    "straggler-storm": straggler_storm,
}


def preset(name: str) -> Scenario:
    """A fresh copy of a built-in scenario by name."""
    try:
        return PRESETS[name]()
    except KeyError:
        raise ValueError(f"unknown preset {name!r} "
                         f"(have: {', '.join(sorted(PRESETS))})") from None
