"""Declarative fault-injection scenarios with deterministic replay (port
of :mod:`repro.scenario`).

Real constellation FL is defined by orbital link churn, relay deaths and
straggler bursts. This package makes those failure modes config files:

* :mod:`repro_torch.scenario.spec` — the declarative scenario schema
  (:class:`Scenario`: link-flap schedules, crash/recovery events,
  straggler windows, bandwidth-degradation ramps, deadline windows) with a
  dict/JSON round-trip (the reference's ``repro.scenario/1`` schema), so a
  scenario travels as a file and rides inside every emitted trace;
* :mod:`repro_torch.scenario.compile` — :func:`compile_scenario` lowers a
  spec onto the objects the simulator already consumes: a padded
  :class:`~repro_torch.agg.schedule.TopologySchedule`, per-round
  participation masks and per-round ``q_budget`` arrays;
* :mod:`repro_torch.scenario.presets` — the four presets;
* :mod:`repro_torch.scenario.run` — ``python -m repro_torch.scenario.run
  spec.json`` runs a scenario through the
  :class:`~repro_torch.fed.simulator.Simulator` and writes a validated
  trace.

Replay is deterministic by construction: every stochastic ingredient is
seeded in the spec and realized at compile time, so the same spec —
loaded from JSON or recovered from an emitted trace via
:func:`spec.scenario_from_trace` — re-runs bit-exactly. The straggler
draws come from a ``torch.Generator`` where the reference uses
``jax.random``: the process is the same, the realized masks are not.
"""

from repro_torch.scenario.compile import CompiledScenario, compile_scenario
from repro_torch.scenario.presets import PRESETS, preset
from repro_torch.scenario.spec import (BandwidthRamp, Crash, DeadlineWindow,
                                 LinkFlap, Scenario, StragglerWindow,
                                 TopologySpec, scenario_from_trace)

__all__ = [
    "Scenario", "TopologySpec", "LinkFlap", "Crash", "StragglerWindow",
    "BandwidthRamp", "DeadlineWindow", "scenario_from_trace",
    "CompiledScenario", "compile_scenario", "PRESETS", "preset",
]
