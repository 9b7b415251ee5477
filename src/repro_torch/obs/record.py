"""Trace schema + plan introspection for round telemetry (port of
:mod:`repro.obs.record`; numpy only).

A trace is a JSONL file: one JSON object per line, every line carrying
``"schema": SCHEMA`` and a ``"kind"``:

* ``meta`` — written once at the head: aggregation config (algorithm, Q
  split, ω), model dimension d, client count, free-form context (backend,
  topology name, git provenance, …);
* ``round`` — one aggregation round: per-stage per-hop §V accounting
  (bits split global/local, nnz, err_sq), the plan shape and its
  reconstructed forest (parent/level per client), participation mask,
  per-client EF mass, the dead-client banked-EF metric, the simulated
  per-hop timeline + critical-path latency (the
  :func:`repro_torch.topo.tree.round_latency_s` model when link attributes
  are
  known, unit hop times otherwise), the cumulative specialization count
  (in the port: the distinct input signatures the rounds met),
  host wall-clock per phase, and — for multi-tenant batched rounds
  (schema ≥ 1.1) — the ``cohort`` id the record belongs to, so one trace
  stays queryable per tenant;
* ``span`` — a host wall-clock interval (benchmark/simulator phase hooks:
  compile, dispatch, flush, …).

Everything here is host-side numpy/python — records are built *after* the
round's logs have been read back from the device, so collection never
changes what a round computes.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np

#: Versioned schema tag carried by every trace line — the reference's tag,
#: unchanged, so that either package's ``report diff`` reads the other's
#: traces. Bump the suffix when a record field changes meaning; readers
#: reject unknown majors.
#: 1.1: round records may carry a ``cohort`` tenant id (batched rounds).
SCHEMA = "repro.obs.trace/1.1"

_KINDS = ("meta", "round", "span")


# ---------------------------------------------------------------------------
# Plan introspection (host-side, numpy)
# ---------------------------------------------------------------------------

def _stage_forest(plan) -> tuple:
    """Reconstruct one stage's forest from its level schedule.

    Returns ``(parent, level)``, both ``[K]`` int arrays: ``parent[i]`` is
    the client receiving i's γ, or ``-(sink+1)`` for hops that deliver to
    sink row *sink* (single-sink plans: -1 = the PS); ``level[i]`` is i's
    schedule level index (0 = deepest level, runs first).
    """
    k = plan.num_clients
    node_id = np.asarray(plan.node_id)
    parent_row = np.asarray(plan.parent_row)
    slot_mask = np.asarray(plan.slot_mask)
    flat_pos = np.asarray(plan.flat_pos)
    w = node_id.shape[1] if node_id.ndim == 2 else 1
    parent = np.full((k,), -1, np.int64)
    for li in range(node_id.shape[0]):
        for wi in range(node_id.shape[1]):
            if slot_mask[li, wi] > 0:
                n = int(node_id[li, wi])
                p = int(parent_row[li, wi])
                if n < k:
                    parent[n] = p if p < k else -(p - k + 1)
    level = (np.asarray(flat_pos, np.int64) // max(1, w))
    return parent, level


def plan_meta(plan) -> dict:
    """Host-side snapshot of a plan's structure for a round record.

    Accepts an :class:`~repro_torch.agg.plan.AggPlan` or a
    :class:`~repro_torch.agg.nested.NestedPlan`; returns ``{"type":
    "flat" | "nested", "stages": [...]}`` where each stage entry carries
    the padded ``(L, W)``, unit/sink counts, aliveness, and the
    reconstructed ``parent``/``level`` arrays (see :func:`_stage_forest`).
    """
    stages = getattr(plan, "stages", None)
    if stages is None:
        stages, ptype = (plan,), "flat"
    else:
        ptype = "nested"
    out = []
    for st in stages:
        parent, level = _stage_forest(st)
        out.append({
            "L": int(np.asarray(st.node_id).shape[0]),
            "W": int(np.asarray(st.node_id).shape[1]),
            "num_clients": int(st.num_clients),
            "num_sinks": int(st.num_sinks),
            "alive": np.asarray(st.alive, np.float64).tolist(),
            "parent": parent.tolist(),
            "level": level.tolist(),
        })
    return {"type": ptype, "stages": out}


def subtree_sizes_from_parent(parent: Sequence[int]) -> np.ndarray:
    """``size[i]`` = #units in the subtree rooted at i (incl. i), from a
    record's ``parent`` array (negatives = sink/PS). The tree Prop-2 bound
    (:func:`repro_torch.core.comm_cost.expected_lambda_nnz_bound_tree`)
    takes
    exactly these — so a trace is self-sufficient for the closed-form
    cross-checks, no topology object needed."""
    parent = np.asarray(parent, np.int64)
    k = len(parent)
    depth = np.zeros((k,), np.int64)
    for i in range(k):
        n, d = i, 1
        while parent[n] >= 0:
            n = int(parent[n])
            d += 1
            if d > k + 1:
                raise ValueError("cycle in recorded forest")
        depth[i] = d
    size = np.ones((k,), np.int64)
    for i in np.argsort(-depth):
        p = parent[int(i)]
        if p >= 0:
            size[p] += size[int(i)]
    return size


# ---------------------------------------------------------------------------
# Simulated per-hop timeline
# ---------------------------------------------------------------------------

def hop_timeline(parent: Sequence[int], level: Sequence[int],
                 bits: Sequence[float], *,
                 bw_bps: Optional[Sequence[float]] = None,
                 latency_s: Optional[Sequence[float]] = None,
                 t_start: float = 0.0) -> tuple:
    """Dataflow start/end times per hop → ``(t0, t1, crit_path)``.

    Hop i starts when all of its children have delivered (``max`` over
    children t1 — the same recurrence as
    :func:`repro_torch.topo.tree.round_latency_s`, whose critical path
    this
    reproduces exactly when ``bw_bps``/``latency_s`` come from the routed
    tree; asserted in tests). Without a link model every hop costs one
    time unit. Zero-bandwidth hops (stranded stubs) are skipped:
    ``t0 == t1 == t_start`` and they never extend the critical path.
    """
    parent = np.asarray(parent, np.int64)
    level = np.asarray(level, np.int64)
    bits = np.asarray(bits, np.float64)
    k = len(parent)
    if bw_bps is not None:
        bw = np.asarray(bw_bps, np.float64)
        lat = (np.zeros((k,)) if latency_s is None
               else np.asarray(latency_s, np.float64))
        tx = np.where(bw > 0, bits / np.maximum(bw, 1e-30) + lat, 0.0)
        skip = bw <= 0
    else:
        tx = np.ones((k,), np.float64)
        skip = np.zeros((k,), bool)
    t0 = np.full((k,), t_start, np.float64)
    t1 = np.full((k,), t_start, np.float64)
    ready = np.zeros((k,), np.float64)
    for i in np.argsort(level, kind="stable"):      # deepest level first
        i = int(i)
        if skip[i]:
            continue
        t0[i] = t_start + ready[i]
        t1[i] = t0[i] + tx[i]
        p = parent[i]
        if p >= 0:
            ready[p] = max(ready[p], t1[i] - t_start)
    sinks = [i for i in range(k) if parent[i] < 0 and not skip[i]]
    crit = max((t1[i] - t_start for i in sinks), default=0.0)
    return t0, t1, crit


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------

def _is_num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _num_list(x, n: Optional[int] = None) -> bool:
    return (isinstance(x, list) and all(_is_num(v) for v in x)
            and (n is None or len(x) == n))


def validate_record(obj) -> list:
    """Schema-validate one trace line → list of error strings (empty = ok)."""
    errs = []
    if not isinstance(obj, dict):
        return [f"record is {type(obj).__name__}, not an object"]
    schema = obj.get("schema", "")
    if (not isinstance(schema, str)
            or schema.split("/")[0] != SCHEMA.split("/")[0]):
        errs.append(f"unknown schema {schema!r}")
    kind = obj.get("kind")
    if kind not in _KINDS:
        return errs + [f"unknown kind {kind!r}"]
    if kind == "meta":
        if not isinstance(obj.get("cfg", {}), dict):
            errs.append("meta.cfg must be an object")
        for key in ("d", "num_clients"):
            if key in obj and not _is_num(obj[key]):
                errs.append(f"meta.{key} must be a number")
    elif kind == "span":
        for key in ("name", "track"):
            if not isinstance(obj.get(key), str):
                errs.append(f"span.{key} must be a string")
        for key in ("t0_s", "dur_s"):
            if not _is_num(obj.get(key)):
                errs.append(f"span.{key} must be a number")
    elif kind == "round":
        if not _is_num(obj.get("round")):
            errs.append("round.round must be a number")
        stages = obj.get("stages")
        if not isinstance(stages, list) or not stages:
            errs.append("round.stages must be a non-empty list")
            stages = []
        for s, st in enumerate(stages):
            if not isinstance(st, dict):
                errs.append(f"stages[{s}] must be an object")
                continue
            n = None
            for key in ("bits", "nnz", "nnz_global", "nnz_local", "err_sq"):
                v = st.get(key)
                if not _num_list(v, n):
                    errs.append(f"stages[{s}].{key} must be a numeric list "
                                f"of the stage's unit count")
                elif n is None:
                    n = len(v)
            for key in ("t0_s", "t1_s", "ef_mass"):
                if key in st and not _num_list(st[key], n):
                    errs.append(f"stages[{s}].{key} length mismatch")
        plan = obj.get("plan")
        if plan is not None:
            if (not isinstance(plan, dict)
                    or plan.get("type") not in ("flat", "nested")
                    or not isinstance(plan.get("stages"), list)):
                errs.append("round.plan malformed")
            else:
                for s, st in enumerate(plan["stages"]):
                    for key in ("parent", "level"):
                        if not _num_list(st.get(key)):
                            errs.append(f"plan.stages[{s}].{key} must be a "
                                        f"numeric list")
        if "participation" in obj and not _num_list(obj["participation"]):
            errs.append("round.participation must be a numeric list")
        for key in ("ef_dead_mass", "crit_path_s", "loss", "retraces"):
            if obj.get(key) is not None and not _is_num(obj[key]):
                errs.append(f"round.{key} must be a number or null")
        cohort = obj.get("cohort")
        if cohort is not None and not (_is_num(cohort)
                                       or isinstance(cohort, str)):
            errs.append("round.cohort must be a number or string")
        tot = obj.get("totals")
        if not isinstance(tot, dict) or not all(
                _is_num(tot.get(key)) for key in ("bits", "nnz", "err_sq")):
            errs.append("round.totals must carry numeric bits/nnz/err_sq")
        phases = obj.get("phases")
        if phases is not None and (
                not isinstance(phases, dict)
                or not all(_is_num(v) for v in phases.values())):
            errs.append("round.phases must map names to seconds")
    return errs


def iter_trace(path: str):
    """Yield parsed records of a JSONL trace (raises on malformed JSON)."""
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError as exc:
                raise ValueError(f"{path}:{ln}: not valid JSON: {exc}")


def validate_trace(path: str) -> dict:
    """Validate a whole trace file.

    Returns ``{"meta": n, "round": n, "span": n, "errors": [...]}`` where
    errors are ``"line N: message"`` strings. A valid trace has at least
    one meta record, and it comes first.
    """
    counts = {k: 0 for k in _KINDS}
    errors = []
    first_kind = None
    for ln, rec in enumerate(iter_trace(path), 1):
        errs = validate_record(rec)
        kind = rec.get("kind") if isinstance(rec, dict) else None
        if kind in counts:
            counts[kind] += 1
            if first_kind is None:
                first_kind = kind
        errors.extend(f"line {ln}: {e}" for e in errs)
    if counts["meta"] == 0:
        errors.append("trace has no meta record")
    elif first_kind != "meta":
        errors.append("meta record must come first")
    counts["errors"] = errors
    return counts
