"""Shape-bucket round scheduler — multi-tenant batched aggregation (port of
:mod:`repro.agg.batching`).

Many independent cohorts (per-region models, A/B arms) served over one
constellation would each pay a whole round of launches.
:class:`RoundScheduler` packs their rounds into **shape buckets** and runs
each bucket through one :func:`repro_torch.agg.plan.execute_batched`:

* a bucket is keyed on client count, sink count, ``q_budget`` presence,
  model dimension and gradient dtype;
* within a bucket, plans of different ``(L, W)`` are padded to the
  bucket's running-maximum shape and stacked with
  :func:`repro_torch.agg.plan.stack_plans` (padding slots change nothing);
* the cohort count is padded up to a power of two with zero dummy cohorts,
  so any number of tenants hits few ``[B, ...]`` shapes.

Each (bucket, padded shape, padded B) is one specialization. The port
compiles nothing, but it keeps the reference's audit: a
:class:`repro_torch.obs.collector.TraceCounter` counts the distinct input
signatures the batched launch meets, read from its tensors, and
:meth:`RoundScheduler.assert_bucket_specializations` holds it to the
number of buckets launched. Each cohort's result equals a sequential
``execute`` on the cohort's own unpadded plan.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.agg.plan import (AggPlan, RoundResult, execute_batched,
                                  stack_plans)
from repro_torch.core.algorithms import AggConfig, HopStats
from repro_torch.obs.collector import TraceCounter, input_signature

Tensor = torch.Tensor


@dataclasses.dataclass
class CohortRound:
    """One tenant's round: a plan and its round inputs. ``global_mask`` and
    ``participate`` may be None (zeros and full participation, the
    ``execute`` defaults)."""

    cohort_id: Hashable
    plan: AggPlan
    grads: Tensor                         # [K, d]
    e: Tensor                             # [K, d]
    weights: Tensor                       # [K]
    global_mask: Optional[Tensor] = None  # [d]
    participate: Optional[Tensor] = None  # [K]


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def _cohort(res: RoundResult, i: int) -> RoundResult:
    return RoundResult(aggregate=res.aggregate[i], e_new=res.e_new[i],
                       stats=HopStats(*(s[i] for s in res.stats)))


class RoundScheduler:
    """Packs heterogeneous cohort rounds into padded shape buckets. One
    scheduler serves one :class:`AggConfig`."""

    def __init__(self, cfg: AggConfig):
        self.cfg = cfg
        self.trace_counter = TraceCounter()
        self._bucket_shape: Dict[tuple, tuple] = {}   # key → running (L, W)
        self._specs: set = set()            # (key, (L, W), B) launched
        self.bucket_log: List[dict] = []    # one entry per bucket launch

    def _run(self, plan, grads, e, weights, global_mask, participate):
        self.trace_counter.observe(input_signature(
            plan.node_id, plan.slot_mask, plan.parent_row, plan.flat_pos,
            plan.alive, plan.q_budget, plan.num_clients, plan.num_sinks,
            grads, e, weights, global_mask, participate))
        return execute_batched(self.cfg, plan, grads, e, weights,
                               global_mask=global_mask,
                               participate=participate)

    # -- bucketing ---------------------------------------------------------

    @staticmethod
    def _bucket_key(r: CohortRound) -> tuple:
        return (r.plan.num_clients, r.plan.num_sinks,
                r.plan.q_budget is not None, r.grads.shape[-1],
                str(r.grads.dtype))

    def _bucket(self, rounds: Sequence[CohortRound]) -> Dict[tuple, list]:
        buckets: Dict[tuple, list] = {}
        for r in rounds:
            if np.ndim(r.plan.node_id) != 2:
                raise ValueError("submit unstacked plans; the scheduler "
                                 "stacks buckets itself")
            buckets.setdefault(self._bucket_key(r), []).append(r)
        return buckets

    @property
    def expected_specializations(self) -> int:
        """Distinct (bucket, padded shape, padded B) launches so far — the
        ceiling the trace counter must not exceed."""
        return len(self._specs)

    def assert_bucket_specializations(self):
        """Raise unless the batched launch met at most one input signature
        per shape bucket."""
        if self.trace_counter.count > self.expected_specializations:
            raise AssertionError(
                f"batched round path traced {self.trace_counter.count}× "
                f"for {self.expected_specializations} shape bucket(s) — "
                f"a plan/input shape is leaking into new specializations")

    # -- execution ---------------------------------------------------------

    def submit(self, rounds: Sequence[CohortRound]
               ) -> Dict[Hashable, RoundResult]:
        """Run every submitted cohort round → per-cohort results. Each
        bucket runs as one batched round; each cohort's ``RoundResult``
        equals a sequential ``execute`` on its own plan."""
        out: Dict[Hashable, RoundResult] = {}
        for key, members in self._bucket(rounds).items():
            shape = self._grow_shape(key, members)
            b, b_pad = len(members), _pow2(len(members))
            plans = [m.plan.pad(shape) for m in members]
            plans += [plans[-1]] * (b_pad - b)          # dummy cohorts
            plan = stack_plans(plans)

            k, d = members[0].grads.shape
            dt, dev = members[0].grads.dtype, members[0].grads.device

            def stack(get, fill, dtype):
                rows = [(fill if get(m) is None else get(m)).to(dev, dtype)
                        for m in members]
                rows += [fill.to(dev, dtype)] * (b_pad - b)
                return torch.stack(rows)

            # masks and participation are exact 0/1 in any float dtype;
            # weights keep their own dtype, as in the sequential round
            zeros = lambda *s: torch.zeros(s, dtype=dt)  # noqa: E731
            grads = stack(lambda m: m.grads, zeros(k, d), dt)
            e = stack(lambda m: m.e, zeros(k, d), dt)
            weights = stack(lambda m: m.weights, zeros(k),
                            members[0].weights.dtype)
            gmask = stack(lambda m: m.global_mask, zeros(d), dt)
            part = stack(lambda m: m.participate, torch.ones(k), dt)

            self._specs.add((key, shape, b_pad))
            self.bucket_log.append(dict(key=key, shape=shape, cohorts=b,
                                        padded_cohorts=b_pad))
            res = self._run(plan, grads, e, weights, gmask, part)
            for i, m in enumerate(members):
                out[m.cohort_id] = _cohort(res, i)
        return out

    def _grow_shape(self, key: tuple, members: Sequence[CohortRound]
                    ) -> tuple:
        shapes = [m.plan.shape for m in members]
        prev = self._bucket_shape.get(key, (1, 1))
        shape = (max(prev[0], *(s[0] for s in shapes)),
                 max(prev[1], *(s[1] for s in shapes)))
        self._bucket_shape[key] = shape
        return shape
