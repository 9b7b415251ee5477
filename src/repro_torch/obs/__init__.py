"""Queryable round telemetry (port of :mod:`repro.obs`).

The executors and the simulator already compute per-hop accounting
(:class:`~repro_torch.core.algorithms.HopStats`). This package turns
those tensors into a structured, queryable trace without touching what a
round computes: a host-side :class:`TraceCollector` consumes the round
outputs after they have been read back and emits versioned
:data:`~repro_torch.obs.record.SCHEMA` records (the reference's schema,
``repro.obs.trace/1.1``) to a JSONL file, so either package's report
reads either package's traces.

* :mod:`repro_torch.obs.record` — the trace schema, plan introspection,
  the simulated per-hop timeline and validation;
* :mod:`repro_torch.obs.collector` — :class:`TraceCollector`,
  :class:`RoundBuffer` (one device→host copy per flush) and
  :class:`TraceCounter` (input-signature accounting);
* :mod:`repro_torch.obs.timing` — :class:`PhaseTimer` host wall-clock
  phases;
* :mod:`repro_torch.obs.chrome` — Chrome trace-event export (Perfetto);
* :mod:`repro_torch.obs.report` — ``python -m repro_torch.obs.report``
  (``summary`` / ``diff`` / ``validate`` / ``export``);
* :mod:`repro_torch.obs.smoke` — the smoke driver (chain, constellation
  tree, nested two-stage plan).
"""

from repro_torch.obs.chrome import chrome_events, export_chrome_trace
from repro_torch.obs.collector import (RoundBuffer, TraceCollector,
                                       TraceCounter, input_signature)
from repro_torch.obs.record import (SCHEMA, hop_timeline, iter_trace,
                                    plan_meta, subtree_sizes_from_parent,
                                    validate_record, validate_trace)
from repro_torch.obs.timing import PhaseTimer

__all__ = [
    "SCHEMA", "TraceCollector", "RoundBuffer", "TraceCounter",
    "input_signature", "PhaseTimer", "plan_meta", "hop_timeline",
    "subtree_sizes_from_parent", "iter_trace", "validate_record",
    "validate_trace", "chrome_events", "export_chrome_trace",
]
