"""Chrome trace-event export — open a whole simulation in Perfetto (port
of :mod:`repro.obs.chrome`).

Converts a ``repro.obs.trace`` JSONL trace (written by either package)
into the Chrome trace-event JSON format (https://ui.perfetto.dev loads it
directly, as does ``chrome://tracing``):

* every **round** record becomes a block of complete ("X") events on the
  simulated time axis — one process per stage, one thread per client/unit,
  one event per hop (duration = the hop's simulated transmit time from
  the record's ``t0_s``/``t1_s``, args = its §V accounting), with rounds
  laid head-to-tail separated by a small gap so the per-level wavefront
  structure of the ``(L, W)`` schedule is visible;
* every **span** record becomes an "X" event on a host wall-clock process
  (one thread per ``track`` name) — the benchmark/simulator phase hooks;
* ``track="scenario"`` spans are special: their ``t0_s``/``dur_s`` are
  *round* coordinates (the scenario engine's injected-fault windows), so
  they render on the simulated axis as an "injected faults" process whose
  events stretch across the rounds they cover — crash/flap/degradation
  windows line up under the hop wavefronts they perturb.

Units: the simulated axis is scaled so 1 second → 1 ms of trace time when
a link model was recorded (critical paths are tens of ms), and 1 unit hop
→ 1 ms otherwise; host spans are real microseconds. The two axes live in
separate processes, so the scaling never mixes.
"""

from __future__ import annotations

import json
from typing import Iterable, Optional

from repro_torch.obs.record import iter_trace

#: pid of the host wall-clock process; stage s uses pid = s + 1.
HOST_PID = 0

#: pid of the injected-fault process (scenario event windows, simulated
#: axis). Large so it sorts after any realistic stage count.
FAULT_PID = 99

#: simulated seconds → trace µs (1 s → 1 ms of trace time)
SIM_SCALE_US = 1e3


def _thread_meta(pid: int, tid: int, name: str) -> dict:
    return {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": name}}


def _process_meta(pid: int, name: str) -> dict:
    return {"ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": name}}


def chrome_events(records: Iterable[dict], *, gap_frac: float = 0.1) -> list:
    """Trace records → list of Chrome trace events (see module doc)."""
    events: list = []
    procs: dict = {}
    threads: dict = {}
    tracks: dict = {}

    def ensure_proc(pid: int, name: str):
        if pid not in procs:
            procs[pid] = True
            events.append(_process_meta(pid, name))

    def ensure_thread(pid: int, tid: int, name: str):
        if (pid, tid) not in threads:
            threads[(pid, tid)] = True
            events.append(_thread_meta(pid, tid, name))

    cursor = 0.0          # simulated-axis cursor (seconds/units)
    scenario_spans: list = []
    round_windows: dict = {}     # round → (sim start, sim end)
    for rec in records:
        kind = rec.get("kind")
        if kind == "span":
            track = rec.get("track", "host")
            if track == "scenario":
                # round-coordinate windows; rendered on the simulated axis
                # once the rounds they span have been laid out
                scenario_spans.append(rec)
                continue
            tid = tracks.setdefault(track, len(tracks))
            ensure_proc(HOST_PID, "host wall-clock")
            ensure_thread(HOST_PID, tid, track)
            ev = {"ph": "X", "name": rec["name"], "pid": HOST_PID,
                  "tid": tid, "ts": rec["t0_s"] * 1e6,
                  "dur": max(rec["dur_s"] * 1e6, 0.01), "cat": "span"}
            if rec.get("args"):
                ev["args"] = rec["args"]
            events.append(ev)
        elif kind == "round":
            rnd = rec.get("round", 0)
            t_end = cursor
            for s, st in enumerate(rec.get("stages", [])):
                t0s, t1s = st.get("t0_s"), st.get("t1_s")
                if t0s is None or t1s is None:
                    continue
                pid = s + 1
                ensure_proc(pid, f"aggregation stage {s}")
                pst = (rec.get("plan", {}).get("stages", [{}] * (s + 1)))[s]
                levels = pst.get("level", [0] * len(t0s))
                for i, (a, b) in enumerate(zip(t0s, t1s)):
                    if b <= a:
                        continue          # skipped hop (stub / zero bw)
                    ensure_thread(pid, i,
                                  f"{'client' if s == 0 else 'unit'} {i}")
                    ev_args = {"round": rnd, "bits": st["bits"][i],
                               "nnz": st["nnz"][i],
                               "err_sq": st["err_sq"][i]}
                    if "cohort" in rec:        # multi-tenant batched round
                        ev_args["cohort"] = rec["cohort"]
                    events.append({
                        "ph": "X", "cat": "hop",
                        "name": f"r{rnd} L{levels[i]} hop {i}",
                        "pid": pid, "tid": i,
                        "ts": (cursor + a) * SIM_SCALE_US,
                        "dur": max((b - a) * SIM_SCALE_US, 0.01),
                        "args": ev_args,
                    })
                    t_end = max(t_end, cursor + b)
            # round boundary marker (instant event on stage 0)
            ensure_proc(1, "aggregation stage 0")
            events.append({"ph": "i", "s": "p", "name": f"round {rnd}",
                           "pid": 1, "tid": 0,
                           "ts": cursor * SIM_SCALE_US,
                           "args": {"round": rnd,
                                    "bits": rec.get("totals", {}).get(
                                        "bits"),
                                    "retraces": rec.get("retraces")}})
            dur = max(t_end - cursor, 1e-9)
            round_windows[rnd] = (cursor, t_end if t_end > cursor
                                  else cursor + dur)
            cursor = t_end + gap_frac * dur

    if scenario_spans and round_windows:
        ensure_proc(FAULT_PID, "injected faults")
        kinds: dict = {}
        last_round = max(round_windows)
        for rec in scenario_spans:
            r0 = int(rec["t0_s"])
            r1 = min(r0 + max(int(rec["dur_s"]), 1) - 1, last_round)
            covered = [round_windows[r] for r in range(r0, r1 + 1)
                       if r in round_windows]
            if not covered:
                continue
            t_start = covered[0][0]
            t_stop = max(b for _, b in covered)
            fkind = (rec.get("args") or {}).get("kind", "event")
            tid = kinds.setdefault(fkind, len(kinds))
            ensure_thread(FAULT_PID, tid, fkind)
            events.append({
                "ph": "X", "cat": "fault", "name": rec["name"],
                "pid": FAULT_PID, "tid": tid,
                "ts": t_start * SIM_SCALE_US,
                "dur": max((t_stop - t_start) * SIM_SCALE_US, 0.01),
                "args": {**(rec.get("args") or {}),
                         "round": r0, "rounds": int(rec["dur_s"])},
            })
    return events


def export_chrome_trace(trace_path: str, out_path: Optional[str] = None,
                        *, gap_frac: float = 0.1) -> str:
    """Convert a JSONL trace file to a Chrome trace JSON file.

    Returns the output path (default: ``<trace>.chrome.json``). Open it at
    https://ui.perfetto.dev (or ``chrome://tracing``).
    """
    if out_path is None:
        base = trace_path[:-6] if trace_path.endswith(".jsonl") \
            else trace_path
        out_path = base + ".chrome.json"
    events = chrome_events(iter_trace(trace_path), gap_frac=gap_frac)
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        f.write("\n")
    return out_path
