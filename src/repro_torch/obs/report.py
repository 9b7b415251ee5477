"""``python -m repro_torch.obs.report`` — summarize, diff, validate traces
(port of :mod:`repro.obs.report`; it reads traces of either package).

Subcommands:

* ``summary TRACE``  — round counts, §V bit totals (global/local split),
  closed-form cross-check against :mod:`repro_torch.core.comm_cost` (CL-SIA
  exact, the Prop-2 ceiling for the stochastic algorithms — subtree sizes
  come from the recorded forest, no topology object needed), critical-path
  histogram, EF-mass growth, retrace events, phase wall-clock totals;
* ``diff A B``       — per-round bits/loss/crit-path deltas between two
  traces (e.g. the JAX package's against the port's, or before/after a
  change);
* ``validate TRACE [TRACE ...]`` — schema validation (CI gate; exit 1 on
  any error);
* ``export TRACE``   — Chrome trace-event conversion
  (:func:`repro_torch.obs.chrome.export_chrome_trace`).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np

from repro_torch.obs.record import (iter_trace, subtree_sizes_from_parent,
                              validate_trace)


def load_trace(path: str) -> tuple:
    """→ (meta record | None, [round records], [span records])."""
    meta, rounds, spans = None, [], []
    for rec in iter_trace(path):
        kind = rec.get("kind")
        if kind == "meta" and meta is None:
            meta = rec
        elif kind == "round":
            rounds.append(rec)
        elif kind == "span":
            spans.append(rec)
    return meta, rounds, spans


# ---------------------------------------------------------------------------
# Closed-form cross-check
# ---------------------------------------------------------------------------

def closed_form_check(meta: Optional[dict], rounds: list) -> Optional[dict]:
    """Measured §V bits vs the :mod:`repro_torch.core.comm_cost` closed
    forms.

    CL-SIA / CL-TC-SIA carry exactly Q (resp. Q_G + Q_L) per hop on any
    tree → equality is expected on full-participation rounds with dense
    inputs; SIA / RE-SIA / TC-SIA are bounded by the tree Prop-2 form with
    the recorded per-stage subtree sizes. Returns None when the trace
    lacks the needed metadata (no cfg, or no recorded plan).
    """
    from repro_torch.core import comm_cost as cc

    if not meta or not meta.get("cfg") or not rounds:
        return None
    cfg, d = meta["cfg"], meta.get("d")
    if d is None or not cfg.get("kind"):
        return None
    kind, omega = cfg["kind"], cfg.get("omega", 32)
    q, qg, ql = cfg.get("q", 0), cfg.get("q_global", 0), cfg.get("q_local", 0)
    exact = kind in ("cl_sia", "cl_tc_sia")
    checked, matches, bounded = 0, 0, 0
    worst = 0.0
    for rec in rounds:
        plan = rec.get("plan")
        if plan is None:
            continue
        part = rec.get("participation")
        full = part is None or all(p > 0 for p in part)
        measured = rec["totals"]["bits"]
        expected = 0.0
        for st in plan["stages"]:
            k_alive = int(round(sum(st.get("alive", [1] * len(st["parent"])))))
            sizes = subtree_sizes_from_parent(st["parent"])
            if kind == "cl_sia":
                expected += cc.cl_sia_bits_tree(k_alive, d, q, omega)
            elif kind == "cl_tc_sia":
                expected += cc.cl_tc_sia_bits_tree(k_alive, d, qg, ql, omega)
            elif kind == "tc_sia":
                expected += cc.tc_sia_bits_bound_tree(sizes, d, qg, ql,
                                                      omega)
            elif kind in ("sia", "re_sia"):
                expected += cc.tc_sia_bits_bound_tree(sizes, d, 0, q, omega)
            elif kind == "dense_ia":
                expected += cc.dense_ia_bits_tree(k_alive, d, omega)
            else:
                return None
        checked += 1
        if exact or kind == "dense_ia":
            if full and abs(measured - expected) < 0.5:
                matches += 1
            worst = max(worst, abs(measured - expected))
        else:
            # Prop-2 bounds the EXPECTED λ-nnz; rounds fluctuate around
            # it, so count as bounded within 2%
            if measured <= 1.02 * expected:
                bounded += 1
            worst = max(worst, measured - expected)
    if not checked:
        return None
    return {"kind": kind, "mode": "exact" if exact or kind == "dense_ia"
            else "ceiling", "rounds_checked": checked, "matches": matches,
            "bounded": bounded, "worst_abs_gap_bits": worst}


# ---------------------------------------------------------------------------
# Summaries
# ---------------------------------------------------------------------------

def _hist(values: list, bins: int = 8, width: int = 40) -> list:
    """ASCII histogram lines."""
    if not values:
        return []
    vals = np.asarray(values, np.float64)
    lo, hi = float(vals.min()), float(vals.max())
    if hi <= lo:
        return [f"  [{lo:.4g}] {'#' * width}  ({len(values)} rounds)"]
    counts, edges = np.histogram(vals, bins=bins)
    peak = max(1, int(counts.max()))
    return [f"  [{edges[i]:.4g}, {edges[i + 1]:.4g}) "
            f"{'#' * max(1, int(width * c / peak)) if c else ''}  {c}"
            for i, c in enumerate(counts)]


def summarize(path: str, *, cohort=None) -> dict:
    """Build the summary dict (the ``summary`` subcommand prints it).

    ``cohort`` restricts the round records to one tenant of a batched
    multi-tenant trace (records tagged ``cohort`` by
    :meth:`~repro_torch.obs.collector.TraceCollector.record_round`).
    """
    meta, rounds, spans = load_trace(path)
    cohorts = sorted({r["cohort"] for r in rounds if "cohort" in r},
                     key=str)
    if cohort is not None:
        rounds = [r for r in rounds
                  if str(r.get("cohort")) == str(cohort)]
    out: dict = {"trace": path, "rounds": len(rounds), "spans": len(spans)}
    if cohorts:
        out["cohorts"] = cohorts
    if cohort is not None:
        out["cohort"] = cohort
    if meta:
        out["cfg"] = meta.get("cfg", {})
        out["d"] = meta.get("d")
        out["num_clients"] = meta.get("num_clients")
        out["context"] = {k: v for k, v in meta.items()
                          if k not in ("schema", "kind", "cfg", "d",
                                       "num_clients", "ts_unix",
                                       "scenario_spec")}
        if meta.get("scenario_spec") is not None:
            out["scenario_spec"] = meta["scenario_spec"]
    if rounds:
        bits = [r["totals"]["bits"] for r in rounds]
        out["bits"] = {"total": float(sum(bits)),
                       "mean_per_round": float(np.mean(bits)),
                       "min": float(min(bits)), "max": float(max(bits))}
        if "bits_global" in rounds[0]["totals"]:
            out["bits"]["global"] = float(
                sum(r["totals"]["bits_global"] for r in rounds))
            out["bits"]["local"] = float(
                sum(r["totals"]["bits_local"] for r in rounds))
        crit = [r["crit_path_s"] for r in rounds
                if r.get("crit_path_s") is not None]
        if crit:
            out["crit_path_s"] = {"min": min(crit), "max": max(crit),
                                  "mean": float(np.mean(crit)),
                                  "values": crit}
        ef = [float(sum(r["stages"][0].get("ef_mass", [0.0])))
              for r in rounds if r["stages"]]
        if any(ef):
            out["ef_mass"] = {"first": ef[0], "last": ef[-1],
                              "peak": max(ef)}
        dead = [r.get("ef_dead_mass") for r in rounds
                if r.get("ef_dead_mass") is not None]
        if dead:
            out["ef_dead_mass"] = {"peak": max(dead), "last": dead[-1],
                                   "rounds_nonzero": sum(1 for v in dead
                                                         if v > 0)}
        retr = [r.get("retraces") for r in rounds
                if r.get("retraces") is not None]
        if retr:
            events = [rounds[i]["round"] for i in range(len(retr))
                      if retr[i] > (retr[i - 1] if i else 0)]
            out["retraces"] = {"total": retr[-1], "events_at_rounds": events}
        losses = [r["loss"] for r in rounds if r.get("loss") is not None]
        if losses:
            out["loss"] = {"first": losses[0], "last": losses[-1]}
        phases: dict = {}
        for r in rounds:
            for name, secs in (r.get("phases") or {}).items():
                phases[name] = phases.get(name, 0.0) + secs
        for sp in spans:
            if sp.get("track") == "scenario":
                continue     # round-coordinate fault windows, not seconds
            phases[sp["name"]] = phases.get(sp["name"], 0.0) + sp["dur_s"]
        if phases:
            out["phases_s"] = phases
        check = closed_form_check(meta, rounds)
        if check:
            out["closed_form"] = check
    injected = [{"name": sp["name"],
                 "kind": (sp.get("args") or {}).get("kind", "event"),
                 "round": int(sp["t0_s"]), "rounds": int(sp["dur_s"])}
                for sp in spans if sp.get("track") == "scenario"]
    if injected:
        out["injected"] = injected
    return out


def print_summary(out: dict) -> None:
    print(f"trace: {out['trace']}")
    if out.get("cohorts"):
        sel = (f" (showing cohort {out['cohort']})"
               if out.get("cohort") is not None else "")
        print(f"cohorts: {', '.join(str(c) for c in out['cohorts'])}{sel}")
    cfg = out.get("cfg") or {}
    if cfg:
        print(f"  algorithm {cfg.get('kind')}  K={out.get('num_clients')}"
              f"  d={out.get('d')}  q={cfg.get('q')}"
              f"  (Q_G={cfg.get('q_global')}, Q_L={cfg.get('q_local')})"
              f"  ω={cfg.get('omega')}")
    ctx = out.get("context") or {}
    if ctx:
        print("  context " + " ".join(f"{k}={v}" for k, v in ctx.items()))
    print(f"  rounds={out['rounds']}  spans={out['spans']}")
    bits = out.get("bits")
    if bits:
        line = (f"  bits: total={bits['total']:.6g}"
                f"  mean/round={bits['mean_per_round']:.6g}")
        if "global" in bits:
            line += (f"  split global={bits['global']:.6g}"
                     f" local={bits['local']:.6g}")
        print(line)
    check = out.get("closed_form")
    if check:
        if check["mode"] == "exact":
            print(f"  closed form ({check['kind']}, exact): "
                  f"{check['matches']}/{check['rounds_checked']} rounds "
                  f"bit-identical (worst gap "
                  f"{check['worst_abs_gap_bits']:.3g} bits)")
        else:
            print(f"  closed form ({check['kind']}, Prop-2 ceiling): "
                  f"{check['bounded']}/{check['rounds_checked']} rounds "
                  f"under the bound (worst overshoot "
                  f"{max(0.0, check['worst_abs_gap_bits']):.3g} bits)")
    crit = out.get("crit_path_s")
    if crit:
        print(f"  crit path s: min={crit['min']:.4g} "
              f"mean={crit['mean']:.4g} max={crit['max']:.4g}")
        for line in _hist(crit["values"]):
            print(line)
    ef = out.get("ef_mass")
    if ef:
        print(f"  EF mass ‖e‖₁: first={ef['first']:.6g} "
              f"last={ef['last']:.6g} peak={ef['peak']:.6g}")
    dead = out.get("ef_dead_mass")
    if dead:
        print(f"  banked EF of dead clients: peak={dead['peak']:.6g} "
              f"last={dead['last']:.6g} "
              f"({dead['rounds_nonzero']} rounds nonzero)")
    retr = out.get("retraces")
    if retr:
        print(f"  specializations (jit traces or input signatures): "
              f"{retr['total']} "
              f"(events at rounds {retr['events_at_rounds']})")
    injected = out.get("injected")
    if injected:
        print(f"  injected events: {len(injected)}")
        for ev in injected:
            span = (f"round {ev['round']}" if ev["rounds"] <= 1 else
                    f"rounds {ev['round']}–{ev['round'] + ev['rounds'] - 1}")
            print(f"    [{ev['kind']}] {ev['name']} ({span})")
    loss = out.get("loss")
    if loss:
        print(f"  loss: {loss['first']:.6g} → {loss['last']:.6g}")
    phases = out.get("phases_s")
    if phases:
        print("  phases (s): " + "  ".join(
            f"{k}={v:.4g}" for k, v in sorted(phases.items())))


def diff(path_a: str, path_b: str, *, limit: int = 10) -> dict:
    """Per-round deltas between two traces (keyed by round number)."""
    _, rounds_a, _ = load_trace(path_a)
    _, rounds_b, _ = load_trace(path_b)
    by_a = {r["round"]: r for r in rounds_a}
    by_b = {r["round"]: r for r in rounds_b}
    common = sorted(set(by_a) & set(by_b))
    deltas = []
    for r in common:
        a, b = by_a[r], by_b[r]
        entry = {"round": r,
                 "bits": b["totals"]["bits"] - a["totals"]["bits"]}
        if a.get("loss") is not None and b.get("loss") is not None:
            entry["loss"] = b["loss"] - a["loss"]
        if (a.get("crit_path_s") is not None
                and b.get("crit_path_s") is not None):
            entry["crit_path_s"] = b["crit_path_s"] - a["crit_path_s"]
        deltas.append(entry)
    out = {"a": path_a, "b": path_b,
           "rounds_a": len(rounds_a), "rounds_b": len(rounds_b),
           "common": len(common),
           "only_a": sorted(set(by_a) - set(by_b)),
           "only_b": sorted(set(by_b) - set(by_a)),
           "bits_total_delta": float(sum(d["bits"] for d in deltas)),
           "rounds_bits_differ": [d["round"] for d in deltas
                                  if abs(d["bits"]) > 0.5][:limit],
           "deltas": deltas}
    return out


def print_diff(out: dict, *, limit: int = 10) -> None:
    print(f"diff: {out['a']}  vs  {out['b']}")
    print(f"  rounds: {out['rounds_a']} vs {out['rounds_b']} "
          f"({out['common']} common"
          + (f", only-a {out['only_a']}" if out["only_a"] else "")
          + (f", only-b {out['only_b']}" if out["only_b"] else "") + ")")
    print(f"  Σ bits delta (b − a): {out['bits_total_delta']:.6g}")
    differing = out["rounds_bits_differ"]
    if differing:
        print(f"  bits differ at rounds {differing}")
    else:
        print("  per-round bits identical")
    shown = 0
    for d in out["deltas"]:
        if shown >= limit:
            break
        extras = "  ".join(f"Δ{k}={v:+.6g}" for k, v in d.items()
                           if k != "round")
        print(f"    round {d['round']}: {extras}")
        shown += 1


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_sum = sub.add_parser("summary", help="summarize one trace")
    p_sum.add_argument("trace")
    p_sum.add_argument("--json", action="store_true",
                       help="machine-readable output")
    p_sum.add_argument("--cohort", default=None,
                       help="restrict to one tenant of a batched trace")
    p_diff = sub.add_parser("diff", help="per-round deltas of two traces")
    p_diff.add_argument("trace_a")
    p_diff.add_argument("trace_b")
    p_diff.add_argument("--json", action="store_true")
    p_diff.add_argument("--limit", type=int, default=10)
    p_val = sub.add_parser("validate", help="schema-validate traces")
    p_val.add_argument("traces", nargs="+")
    p_exp = sub.add_parser("export", help="Chrome trace-event export")
    p_exp.add_argument("trace")
    p_exp.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.cmd == "summary":
        out = summarize(args.trace, cohort=args.cohort)
        if args.json:
            print(json.dumps(out, indent=1, sort_keys=True))
        else:
            print_summary(out)
        return 0
    if args.cmd == "diff":
        out = diff(args.trace_a, args.trace_b, limit=args.limit)
        if args.json:
            out = dict(out)
            out.pop("deltas")
            print(json.dumps(out, indent=1, sort_keys=True))
        else:
            print_diff(out, limit=args.limit)
        return 0
    if args.cmd == "validate":
        failed = False
        for path in args.traces:
            res = validate_trace(path)
            errs = res.pop("errors")
            status = "OK" if not errs else f"{len(errs)} ERRORS"
            print(f"{path}: {status}  "
                  + " ".join(f"{k}={v}" for k, v in res.items()))
            for e in errs[:20]:
                print(f"  {e}")
            failed = failed or bool(errs)
        return 1 if failed else 0
    if args.cmd == "export":
        from repro_torch.obs.chrome import export_chrome_trace
        out_path = export_chrome_trace(args.trace, args.out)
        print(f"wrote {out_path}")
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
