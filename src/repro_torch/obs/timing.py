"""Wall-clock phase hooks for benchmarks and host loops (port of
:mod:`repro.obs.timing`).

:class:`PhaseTimer` measures *host* intervals: plan lookup, dispatch,
flush/sync. On the card the kernels run asynchronously, so what it times
is the host's dispatch (plus any blocking the caller does), which is
exactly the honest host-side quantity; per-op device timings belong to
the profiler, not the trace.

Spans accumulate in memory; :meth:`PhaseTimer.emit` writes them to a
:class:`~repro_torch.obs.collector.TraceCollector` as ``span`` records
(one Perfetto track per ``track`` name) and :meth:`PhaseTimer.totals` folds
them into the per-phase seconds a round record carries.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional


class PhaseTimer:
    """Accumulates named host wall-clock spans.

    >>> timer = PhaseTimer()
    >>> with timer.phase("compile", track="bench"):
    ...     run_once()
    >>> timer.totals()["compile"]
    """

    def __init__(self):
        self.spans: list = []          # (name, track, t0_s, dur_s, args)
        self._origin = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str, *, track: str = "host",
              args: Optional[dict] = None):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            t1 = time.perf_counter()
            self.spans.append((name, track, t0 - self._origin, t1 - t0,
                               args))

    def add(self, name: str, dur_s: float, *, track: str = "host",
            args: Optional[dict] = None) -> None:
        """Record an externally-measured duration at the current cursor."""
        self.spans.append((name, track,
                           time.perf_counter() - self._origin - dur_s,
                           dur_s, args))

    def totals(self) -> dict:
        """Summed seconds per phase name."""
        out: dict = {}
        for name, _, _, dur, _ in self.spans:
            out[name] = out.get(name, 0.0) + dur
        return out

    def take(self) -> dict:
        """:meth:`totals` then reset — the per-round phases dict."""
        out = self.totals()
        self.spans = []
        return out

    def emit(self, collector) -> int:
        """Write every span to ``collector`` as ``span`` records."""
        n = 0
        for name, track, t0, dur, args in self.spans:
            if collector.record_span(name, t0, dur, track=track,
                                     args=args) is not None:
                n += 1
        return n
