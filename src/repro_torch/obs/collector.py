"""Host-side trace collection: JSONL emitter, read-back batching and
specialization counting (port of :mod:`repro.obs.collector`).

:class:`TraceCollector` is the single write path for round telemetry. It
is deliberately dumb about execution: callers hand it the *outputs* of a
round (HopStats, EF-mass vectors, a plan for structure) and it serializes
versioned records (:mod:`repro_torch.obs.record`, the reference's schema).
It never touches what a round computes, and a disabled collector is a
no-op returning immediately from every method.

:class:`RoundBuffer` is the device→host read-back discipline: per-round
logs are appended without being read (the rounds already issued keep
running on the card) and are read back with **one** device→host copy per
flush — every buffered tensor's bytes packed into one buffer on its
device and copied once, never one synchronizing read per leaf.

:class:`TraceCounter` counts specializations. The reference counts jit
traces: its counter is bumped inside a jitted body, which runs once per
new input shape. The port compiles nothing, so a call site reports the
signature of its inputs instead — the shapes and dtypes of every array it
is given, which is what a jit cache keys on — and the counter counts the
first call at each signature. A shape that leaks into the signature (a
plan not padded to its bucket, a cohort count not padded to a power of
two) shows as a count above the expected one, as a retrace does in the
reference.
"""

from __future__ import annotations

import json
import time
from typing import Any, Hashable, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs.record import SCHEMA, hop_timeline, plan_meta


def input_signature(*xs: Any) -> tuple:
    """The shapes and dtypes of ``xs``: tensors and arrays give
    ``(shape, dtype)``, ``None`` stays ``None``, anything else (a static
    argument) stands as itself."""
    sig = []
    for x in xs:
        if isinstance(x, (torch.Tensor, np.ndarray)):
            sig.append((tuple(x.shape), str(x.dtype)))
        else:
            sig.append(x)
    return tuple(sig)


class TraceCounter:
    """Counts specializations: ``bump()`` once per new one, or
    ``observe(signature)`` for every call, which bumps at the first call
    of each signature."""

    def __init__(self):
        self.count = 0
        self._seen: set = set()

    def bump(self) -> int:
        self.count += 1
        return self.count

    def observe(self, signature: Hashable) -> int:
        if signature not in self._seen:
            self._seen.add(signature)
            self.bump()
        return self.count


class _Leaf:
    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


def _strip(tree, leaves: list):
    """``tree`` with every tensor replaced by its index in ``leaves``
    (tuples, named tuples, lists and dicts are walked)."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _Leaf(len(leaves) - 1)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_strip(x, leaves) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_strip(x, leaves) for x in tree)
    if isinstance(tree, dict):
        return {k: _strip(v, leaves) for k, v in tree.items()}
    return tree


def _fill(tree, host: list):
    if isinstance(tree, _Leaf):
        return host[tree.index]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_fill(x, host) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_fill(x, host) for x in tree)
    if isinstance(tree, dict):
        return {k: _fill(v, host) for k, v in tree.items()}
    return tree


def _to_host(leaves: list) -> list:
    """Every tensor of ``leaves`` on the CPU, bit for bit, with one copy
    per device: each tensor's bytes are packed into one buffer on its
    device, the buffer is copied once, and the copy is cut back into
    tensors of the original dtypes and shapes."""
    host = list(leaves)
    by_device: dict = {}
    for i, x in enumerate(leaves):
        if x.device.type != "cpu":
            by_device.setdefault(x.device, []).append(i)
    for idx in by_device.values():
        parts = [leaves[i].detach().reshape(-1).contiguous().view(
            torch.uint8) for i in idx]
        flat = torch.cat(parts).cpu()
        off = 0
        for i, part in zip(idx, parts):
            n = part.numel()
            x = leaves[i]
            host[i] = flat[off:off + n].clone().view(x.dtype).reshape(
                x.shape)
            off += n
    return host


class RoundBuffer:
    """Buffers per-round logs; one device→host copy per :meth:`flush`."""

    def __init__(self):
        self._pending: list = []

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, payload: Any) -> None:
        """Append a round's payload (tensors on the device) *without*
        reading it."""
        self._pending.append(payload)

    def flush(self) -> list:
        """Everything buffered, its tensors copied to the CPU with one
        device→host copy (per device holding any of them)."""
        if not self._pending:
            return []
        leaves: list = []
        skeleton = _strip(self._pending, leaves)
        self._pending = []
        return _fill(skeleton, _to_host(leaves))


def _host(x):
    """A tensor (read back already, or read here) → numpy; anything else
    as it is."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _tolist(x) -> list:
    return np.asarray(_host(x), np.float64).reshape(-1).tolist()


class TraceCollector:
    """Emit round/span telemetry records to a JSONL trace file.

    ``enabled=False`` (or ``path=None``) turns every method into an
    immediate no-op — the zero-cost-when-disabled contract. ``cfg``/``d``
    (an :class:`~repro_torch.core.algorithms.AggConfig` and the flat model
    dimension) feed the meta record and the global/local bit split;
    either may also be supplied later via :meth:`configure` (the
    simulator fills them in when the caller did not).
    """

    def __init__(self, path: Optional[str], *, cfg=None, d: Optional[int]
                 = None, num_clients: Optional[int] = None,
                 meta: Optional[dict] = None, enabled: bool = True):
        self.path = path
        self.enabled = bool(enabled) and path is not None
        self.cfg = cfg
        self.d = d
        self.num_clients = num_clients
        self.meta = dict(meta or {})
        self.records_written = 0
        self._f = None

    # -- lifecycle ----------------------------------------------------------

    def configure(self, *, cfg=None, d: Optional[int] = None,
                  num_clients: Optional[int] = None, **meta) -> None:
        """Fill in missing context before the first record (idempotent —
        never overwrites values the constructor already set)."""
        if self._f is not None:
            return
        if self.cfg is None:
            self.cfg = cfg
        if self.d is None:
            self.d = d
        if self.num_clients is None:
            self.num_clients = num_clients
        for key, val in meta.items():
            self.meta.setdefault(key, val)

    def _write(self, obj: dict) -> None:
        if self._f is None:
            self._f = open(self.path, "w")
            self._f.write(json.dumps(self._meta_record()) + "\n")
            self.records_written += 1
        self._f.write(json.dumps(obj, separators=(",", ":"),
                                  allow_nan=False) + "\n")
        self.records_written += 1

    def _meta_record(self) -> dict:
        cfg = {}
        if self.cfg is not None:
            cfg = {"kind": str(getattr(self.cfg.kind, "value", self.cfg.kind)),
                   "q": self.cfg.q, "q_global": self.cfg.q_global,
                   "q_local": self.cfg.q_local, "omega": self.cfg.omega,
                   "topq_impl": self.cfg.topq_impl,
                   "kernel_mode": self.cfg.kernel_mode}
        out = {"schema": SCHEMA, "kind": "meta", "ts_unix": time.time(),
               "cfg": cfg, **self.meta}
        if self.d is not None:
            out["d"] = int(self.d)
        if self.num_clients is not None:
            out["num_clients"] = int(self.num_clients)
        return out

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- records ------------------------------------------------------------

    def record_round(self, rnd: int, stats, *, plan=None, tree=None,
                     loss=None, participate=None, ef_mass=None,
                     stage_ef_mass: Sequence = (), ef_dead_mass=None,
                     retraces: Optional[int] = None,
                     phases: Optional[dict] = None,
                     cohort=None) -> Optional[dict]:
        """Record one aggregation round.

        ``stats`` is a :class:`~repro_torch.core.algorithms.HopStats`
        (leaves [K]) or a per-stage sequence of them (stage 0 first — the
        :class:`~repro_torch.agg.nested.NestedResult` layout). Array
        inputs may be numpy or tensors (read back already: the simulator
        hands over the CPU copies of a flush). ``plan`` contributes
        structure (forest + levels + the simulated timeline); ``tree`` (an
        :class:`~repro_torch.topo.tree.AggTree` with link attributes)
        upgrades stage 0's timeline to the
        :func:`~repro_torch.topo.tree.round_latency_s` link model, which
        defines ``crit_path_s``. ``cohort`` tags the record with its tenant
        id when the round came out of a batched multi-tenant round
        (:meth:`repro_torch.fed.simulator.Simulator.run_batched`) —
        per-cohort records
        of one batched round share a ``round`` number and differ only in
        ``cohort``, so traces stay queryable per tenant.
        """
        if not self.enabled:
            return None
        if hasattr(stats, "bits"):
            stats = (stats,)
        stats = tuple(stats)
        stage_ef_mass = tuple(stage_ef_mass)

        stages = []
        for s, st in enumerate(stats):
            entry = {
                "bits": _tolist(st.bits),
                "nnz": _tolist(st.nnz_out),
                "nnz_global": _tolist(st.nnz_global),
                "nnz_local": _tolist(st.nnz_local),
                "err_sq": _tolist(st.err_sq),
            }
            if s == 0 and ef_mass is not None:
                entry["ef_mass"] = _tolist(ef_mass)
            elif s >= 1 and s - 1 < len(stage_ef_mass):
                entry["ef_mass"] = _tolist(stage_ef_mass[s - 1])
            stages.append(entry)

        pmeta = None
        crit_path = None
        if plan is not None:
            pmeta = plan_meta(plan)
            if len(pmeta["stages"]) != len(stages):
                raise ValueError(
                    f"plan has {len(pmeta['stages'])} stages, stats "
                    f"{len(stages)}")
            t_cursor = 0.0
            for s, (pst, entry) in enumerate(zip(pmeta["stages"], stages)):
                bw = lat = None
                if (s == 0 and tree is not None
                        and tree.uplink_bw_bps is not None):
                    bw, lat = tree.uplink_bw_bps, tree.uplink_latency_s
                t0, t1, crit = hop_timeline(
                    pst["parent"], pst["level"], entry["bits"],
                    bw_bps=bw, latency_s=lat, t_start=t_cursor)
                entry["t0_s"] = t0.tolist()
                entry["t1_s"] = t1.tolist()
                t_cursor = t_cursor + crit
                if s == 0 and bw is not None:
                    crit_path = crit

        totals = {
            "bits": float(sum(sum(e["bits"]) for e in stages)),
            "nnz": float(sum(sum(e["nnz"]) for e in stages)),
            "err_sq": float(sum(sum(e["err_sq"]) for e in stages)),
        }
        if self.cfg is not None and self.d is not None:
            from repro_torch.core.comm_cost import idx_bits
            ng = sum(sum(e["nnz_global"]) for e in stages)
            nl = sum(sum(e["nnz_local"]) for e in stages)
            totals["bits_global"] = float(self.cfg.omega * ng)
            totals["bits_local"] = float(
                (self.cfg.omega + idx_bits(self.d)) * nl)

        out = {"schema": SCHEMA, "kind": "round", "round": int(rnd),
               "stages": stages, "totals": totals}
        if pmeta is not None:
            out["plan"] = pmeta
        if participate is not None:
            out["participation"] = _tolist(participate)
        if ef_dead_mass is not None:
            out["ef_dead_mass"] = float(np.asarray(_host(ef_dead_mass)))
        if crit_path is not None:
            out["crit_path_s"] = float(crit_path)
        if loss is not None:
            out["loss"] = float(np.asarray(_host(loss)))
        if retraces is not None:
            out["retraces"] = int(retraces)
        if phases:
            out["phases"] = {k: float(v) for k, v in phases.items()}
        if cohort is not None:
            out["cohort"] = (cohort if isinstance(cohort, (int, str))
                             else str(cohort))
        self._write(out)
        return out

    def record_span(self, name: str, t0_s: float, dur_s: float, *,
                    track: str = "host",
                    args: Optional[dict] = None) -> Optional[dict]:
        """Record one host wall-clock interval (a benchmark/loop phase)."""
        if not self.enabled:
            return None
        out = {"schema": SCHEMA, "kind": "span", "name": str(name),
               "track": str(track), "t0_s": float(t0_s),
               "dur_s": float(dur_s)}
        if args:
            out["args"] = args
        self._write(out)
        return out

    def record_train_metrics(self, step: int, metrics: dict,
                             **kwargs) -> Optional[dict]:
        """Adapter for a training step's scalar metrics (the reference's
        ``build_train_step``; its port is ROADMAP A13).

        A train step reduces wire accounting to scalars
        (``agg_bits``/``agg_nnz``/``agg_err_sq`` and the telemetry EF
        masses) — record them as a single-hop round so train runs and
        simulator runs share one trace schema.
        """
        if not self.enabled:
            return None
        from repro_torch.core.algorithms import HopStats

        def scalar(key):
            return float(np.asarray(_host(metrics[key])))

        bits = np.asarray([scalar("agg_bits")])
        nnz = np.asarray([scalar("agg_nnz")])
        stats = HopStats(nnz_out=nnz, nnz_global=np.zeros_like(nnz),
                         nnz_local=nnz, bits=bits,
                         err_sq=np.asarray([scalar("agg_err_sq")]))
        return self.record_round(
            step, stats, loss=metrics.get("loss"),
            ef_mass=(None if "ef_mass" not in metrics
                     else [scalar("ef_mass")]),
            ef_dead_mass=metrics.get("ef_dead_mass"), **kwargs)
