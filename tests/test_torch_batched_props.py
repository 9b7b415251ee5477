"""Property tests (hypothesis) of the port's batched rounds: random bucket
packings.

The port of ``tests/test_batched_rounds_props.py``. A random cohort count,
a random mix of chain, permuted-chain and random-tree plans, random
straggler sets and random extra padding give, for every cohort, the result
of the port's sequential ``execute`` on that cohort's own plan, bit for bit
(``err_sq`` included); and :class:`repro_torch.agg.RoundScheduler` never
meets more input signatures than it launched buckets. Examples:
``max_examples`` 15 for the stacked packings, 10 for the scheduler, as in
the reference.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.agg import (CohortRound, RoundScheduler,  # noqa: E402
                             compile_plan, execute, execute_batched,
                             stack_plans)
from repro_torch.core.algorithms import AggConfig, AggKind  # noqa: E402
from repro_torch.topo.tree import PS, AggTree  # noqa: E402

torch.set_num_threads(1)

ALL_KINDS = [AggKind.SIA, AggKind.RE_SIA, AggKind.CL_SIA, AggKind.TC_SIA,
             AggKind.CL_TC_SIA]

D = 32


def _same(a, b):
    a, b = a.numpy(), b.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


def _assert_result(got, ref):
    _same(got.aggregate, ref.aggregate)
    _same(got.e_new, ref.e_new)
    for a, b in zip(got.stats, ref.stats):
        _same(a, b)


def _random_plan(data, k, label):
    shape_kind = data.draw(st.sampled_from(["chain", "perm", "tree"]),
                           label=f"{label}-topology")
    if shape_kind == "chain":
        return compile_plan(k)
    if shape_kind == "perm":
        return compile_plan(data.draw(st.permutations(list(range(k))),
                                      label=f"{label}-order"))
    parent = [PS]
    for i in range(1, k):
        parent.append(data.draw(st.integers(0, i - 1),
                                label=f"{label}-parent{i}"))
    return compile_plan(AggTree(parent=tuple(parent)))


def _inputs(data, k, seed, label):
    r = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    g = t(r.standard_normal((k, D)))
    e = t(0.1 * r.standard_normal((k, D)))
    w = t(r.uniform(0.5, 2.0, (k,)))
    p = t(data.draw(st.lists(st.sampled_from([0.0, 1.0]), min_size=k,
                             max_size=k), label=f"{label}-part"))
    return g, e, w, p


def _gmask(cfg, seed):
    if cfg.kind in (AggKind.TC_SIA, AggKind.CL_TC_SIA):
        r = np.random.default_rng(seed + 999)
        gm = torch.zeros((D,))
        gm[torch.from_numpy(r.choice(D, size=cfg.q_global,
                                     replace=False))] = 1.0
        return gm
    return None


@settings(max_examples=15, deadline=None)
@given(data=st.data(), kind=st.sampled_from(ALL_KINDS),
       seed=st.integers(0, 2**16))
def test_random_packings_bitwise_per_cohort(data, kind, seed):
    """stack_plans over a random padded bucket == sequential, bitwise."""
    cfg = AggConfig(kind=kind, q=7, q_global=5, q_local=3)
    b = data.draw(st.integers(1, 4), label="B")
    k = data.draw(st.integers(2, 6), label="k")
    plans = [_random_plan(data, k, f"c{i}") for i in range(b)]
    pad_l = data.draw(st.integers(0, 2), label="padL")
    pad_w = data.draw(st.integers(0, 2), label="padW")
    shape = (max(p.shape[0] for p in plans) + pad_l,
             max(p.shape[1] for p in plans) + pad_w)
    stacked = stack_plans([p.pad(shape) for p in plans])

    ins = [_inputs(data, k, seed + 31 * i, f"c{i}") for i in range(b)]
    gm = _gmask(cfg, seed)
    g, e, w, p = (torch.stack([c[j] for c in ins]) for j in range(4))
    gm_b = None if gm is None else gm.expand(b, D).contiguous()
    res = execute_batched(cfg, stacked, g, e, w, global_mask=gm_b,
                          participate=p)
    for i in range(b):
        ref = execute(cfg, plans[i], *ins[i][:3], global_mask=gm,
                      participate=ins[i][3])
        got = type(res)(res.aggregate[i], res.e_new[i],
                        type(res.stats)(*(s[i] for s in res.stats)))
        _assert_result(got, ref)


@settings(max_examples=10, deadline=None)
@given(data=st.data(), seed=st.integers(0, 2**16))
def test_scheduler_random_buckets_bitwise_and_bounded(data, seed):
    """Random multi-bucket submissions: per-cohort bitwise parity and at
    most one input signature per (bucket, shape, padded B)."""
    cfg = AggConfig(kind=AggKind.CL_SIA, q=7)
    sched = RoundScheduler(cfg)
    n_submits = data.draw(st.integers(1, 3), label="submits")
    cid = 0
    for s in range(n_submits):
        subs = []
        for _ in range(data.draw(st.integers(1, 5), label=f"s{s}-n")):
            k = data.draw(st.sampled_from([3, 5]), label=f"s{s}-k")
            plan = _random_plan(data, k, f"s{s}-c{cid}")
            g, e, w, p = _inputs(data, k, seed + 7 * cid, f"s{s}-c{cid}")
            subs.append(CohortRound(cohort_id=cid, plan=plan, grads=g,
                                    e=e, weights=w, participate=p))
            cid += 1
        res = sched.submit(subs)
        for r in subs:
            ref = execute(cfg, r.plan, r.grads, r.e, r.weights,
                          participate=r.participate)
            _assert_result(res[r.cohort_id], ref)
    sched.assert_bucket_specializations()
    assert sched.trace_counter.count <= len(sched._specs)
